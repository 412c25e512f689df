"""DPASGD over the multigraph plan, silo by silo, in plain PyTorch: the
benchmark's reference for what one `run_fl` call produces.

Every silo starts from the same parameters. A round is: one plain SGD
step per local update on each silo's own batch (`torch.autograd.grad`
of the mean cross-entropy, ``w - lr * g``); then each directed edge
whose pair is strong in the round's state takes its source's fresh
parameters into its buffer, and a weak edge keeps the stale buffer; then
every silo averages, ``w_i <- A_ii w_i + sum_e A[i, src e] buf_e`` over
its incoming edges, with the overlay's Metropolis-Hastings weights.
A round's loss is the mean over silos and local updates; an evaluation,
every ``eval_every`` rounds and after the last, is the accuracy of the
silos' mean parameters on the 512 test samples.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from bench.reference import overlay

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def load_model(config_name: str):
    """The configuration's plain reference module, beside its file of
    sizes: ``init(cfg, gen)`` and ``apply(cfg, params, x)``."""
    path = CONFIGS / f"{config_name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_ref_{config_name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _unflatten(names, shapes, flat):
    tree, off = {}, 0
    for name, shape in zip(names, shapes):
        n = int(np.prod(shape))
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = flat[off:off + n].view(shape)
        off += n
    return tree


def plan_of(cfg: dict, traffic: dict):
    """(topology module, round plan) of a run: the traffic's ``topology``
    names `topology_<name>.py`, which plans over the traffic's network."""
    topo = importlib.import_module(
        f"bench.reference.topology_{traffic['topology']}")
    net = overlay.load_network(traffic["network"])
    return topo, topo.plan(net, cfg["workload"], traffic)


def sample_round(data, local_updates: int, batch_size: int, rng):
    """One round's batches, ``[u][silo] -> (x, y)``, drawn with
    replacement from one stream: local update by local update, silo by
    silo, as `run_fl` draws them."""
    out = []
    for _ in range(local_updates):
        per = []
        for x, y in zip(data.silo_x, data.silo_y):
            sel = rng.integers(0, len(x), size=batch_size)
            per.append((x[sel], y[sel]))
        out.append(per)
    return out


@dataclasses.dataclass
class Run:
    round_losses: list
    eval_rounds: list
    eval_accs: list
    cycle_times_ms: list
    mean_cycle_ms: float
    total_time_s: float


#: Precisions of the reference's products: ``fp32`` is the reference;
#: the others are the controls, ``tf32`` every matrix product and
#: convolution in TF32, ``tf32_backward`` the forward pass in fp32 and
#: only the backward pass in TF32.
PRECISIONS = ("fp32", "tf32", "tf32_backward")


def _allow_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def run(cfg: dict, traffic: dict, seed: int, *, device, check_rounds: int,
        precision: str = "fp32") -> Run:
    """The reference's run of ``cfg`` under ``traffic`` from ``seed``,
    trained for the first ``check_rounds`` rounds (evaluations at the
    traffic's ``eval_every`` within them), with the simulated clock over
    all of the traffic's rounds. ``precision`` (one of `PRECISIONS`) other
    than fp32 computes on a card in TF32: the precision controls."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}; known: {PRECISIONS}")
    fwd_tf32 = precision == "tf32"
    bwd_tf32 = precision != "fp32"
    _allow_tf32(fwd_tf32)
    model = load_model(cfg["name"])
    topo, plan = plan_of(cfg, traffic)
    taus = topo.cycle_times(plan, traffic["rounds"])
    n = plan.num_silos
    dataset = importlib.import_module(
        f"bench.reference.dataset_{cfg['data']['kind']}")
    data = dataset.make_dataset(cfg["data"], n, traffic["samples_per_silo"],
                                traffic["alpha"], seed)
    params0 = model.init(cfg, torch.Generator().manual_seed(seed))
    names, leaves = zip(*_leaves(params0))
    shapes = [tuple(x.shape) for x in leaves]
    w = torch.cat([x.reshape(-1) for x in leaves]).to(device)
    w = [w.clone() for _ in range(n)]
    src, dst = plan.src.tolist(), plan.dst.tolist()
    buf = [w[s].clone() for s in src]
    in_edges = [[e for e in range(len(dst)) if dst[e] == i]
                for i in range(n)]
    test_x = torch.as_tensor(data.test_x, device=device)
    test_y = torch.as_tensor(data.test_y, device=device)
    rng = np.random.default_rng(seed + 1)
    lr = cfg["lr"]
    losses, eval_rounds, eval_accs = [], [], []

    def loss_and_grad(flat, x, y):
        flat = flat.detach().requires_grad_(True)
        _allow_tf32(fwd_tf32)
        logits = model.apply(cfg, _unflatten(names, shapes, flat), x)
        loss = F.cross_entropy(logits, y)
        _allow_tf32(bwd_tf32)
        g, = torch.autograd.grad(loss, flat)
        _allow_tf32(fwd_tf32)
        return loss.detach(), g

    for k in range(check_rounds):
        batches = sample_round(data, cfg["local_updates"],
                               cfg["batch_size"], rng)
        round_loss = []
        for per_silo in batches:
            for i, (x, y) in enumerate(per_silo):
                loss, g = loss_and_grad(
                    w[i], torch.as_tensor(x, device=device),
                    torch.as_tensor(y, device=device))
                w[i] = w[i] - lr * g
                round_loss.append(loss)
        strong, coeffs, diag = plan.round(k)
        coeffs, diag = coeffs.tolist(), diag.tolist()
        for e in range(len(src)):
            if strong[e]:
                buf[e] = w[src[e]].clone()
        new_w = []
        for i in range(n):
            acc = diag[i] * w[i]
            for e in in_edges[i]:
                acc = acc + coeffs[e] * buf[e]
            new_w.append(acc)
        w = new_w
        losses.append(float(torch.stack(round_loss).mean()))
        if ((k + 1) % traffic["eval_every"] == 0
                or k + 1 == traffic["rounds"]):
            with torch.no_grad():
                mean = torch.stack(w).mean(dim=0)
                logits = model.apply(cfg, _unflatten(names, shapes, mean),
                                     test_x)
                eval_accs.append(float(
                    (logits.argmax(-1) == test_y).float().mean()))
            eval_rounds.append(k + 1)
    return Run(round_losses=losses, eval_rounds=eval_rounds,
               eval_accs=eval_accs, cycle_times_ms=taus.tolist(),
               mean_cycle_ms=float(taus.mean()),
               total_time_s=float(taus.sum()) / 1000.0)

