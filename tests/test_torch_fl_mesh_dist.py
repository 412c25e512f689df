"""The mesh runtime over `launch.mesh.GroupShards`, one shard per process
of a gloo process group on the CPU, against the same cycle on
`StackedShards` in one process: a whole gaia multigraph cycle of a toy
model at momentum 0.9, with in-cycle metrics, for both gossip backends,
over the 4-rank world (D = 4) and over two 2-rank groups carved out of
it (D = 2, peers named by group rank). The gathered state, the losses
and the metric rows are bit-equal to the stacked binding's, and the
ranks' byte counters add up to its counter. Then `run_fl(mesh="auto")`
inside the 4-rank group: every rank's losses and accuracies equal the
single-device run's, and so do the rows of the checkpoint rank 0 writes.

Each run of 4 processes has a deadline: a hang fails the test instead of
holding up the suite.
"""

import socket
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.checkpoint import load_fl_checkpoint
from repro_torch.core.delay import FEMNIST
from repro_torch.fl import FLConfig, dpasgd, run_fl
from repro_torch.fl import flat as flatmod
from repro_torch.fl import mesh as pmesh
from repro_torch.fl import runtime as prt
from repro_torch.launch.mesh import GroupShards, StackedShards
from repro_torch.networks.registry import get_network
from repro_torch.obs import MetricsSpec
from repro_torch.optim import flat_sgd

WORLD = 4
DEADLINE_S = 120
D_MODEL = 8
FEMNIST_RUN = dict(dataset="femnist", network="gaia", rounds=2,
                   eval_every=1, samples_per_silo=8, batch_size=2,
                   momentum=0.9, seed=3)


def _toy_loss(p, batch):
    return torch.sum((p["w"] - batch["t"]) ** 2) + torch.sum(p["b"] ** 2)


def _inputs():
    plan, _ = dpasgd.make_round_schedule("multigraph", get_network("gaia"),
                                         FEMNIST, t=5)
    n = plan.diag.shape[1]
    rng = np.random.default_rng(5)
    params = {"w": torch.from_numpy(rng.normal(size=D_MODEL).astype(
        np.float32)), "b": torch.zeros(3)}
    rt = prt.make_flat_runtime(plan, params, n)
    batches = {"t": torch.from_numpy(rng.normal(
        size=(plan.num_rounds_cycle, 1, n, 1, D_MODEL)).astype(np.float32))}
    return rt, flatmod.ravel(rt.spec, params), batches


def _cycles(axis):
    """Per backend: (gathered w, buffers, mu, losses, metrics, bytes)."""
    rt, w0, batches = _inputs()
    plan_t = [torch.as_tensor(x) for x in (rt.strong, rt.coeffs, rt.diag)]
    out = {}
    for backend in ("halo", "all_gather"):
        opt = flat_sgd(0.05, momentum=0.9)
        mrt = pmesh.make_mesh_runtime(rt, axis)
        cycle = prt.make_cycle_fn(mrt, loss_fn=_toy_loss, opt=opt,
                                  gossip=backend, metrics=MetricsSpec())
        axis.bytes_moved = 0
        state, losses, mets = cycle(pmesh.init_mesh_state(w0, opt, mrt),
                                    batches, *plan_t)
        moved = axis.bytes_moved
        flat = pmesh.gather_flat_state(mrt, state)
        out[backend] = (flat.w, flat.buffers, flat.opt_state["mu"], losses,
                        mets, moved)
    return out


def _worker(rank, port, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=WORLD, rank=rank)
    try:
        world = _cycles(GroupShards())
        pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
        pair = _cycles(GroupShards(pairs[rank // 2]))
        ckpt = f"{out_dir}/ckpt"
        r = run_fl(FLConfig(**FEMNIST_RUN, mesh="auto", ckpt_dir=ckpt),
                   device="cpu")
        torch.save({"world": world, "pair": pair,
                    "run_fl": (r.round_losses, r.eval_accs)},
                   f"{out_dir}/{rank}.pt")
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def group_results(tmp_path_factory):
    out = tmp_path_factory.mktemp("gloo_mesh")
    ctx = mp.start_processes(_worker, args=(_free_port(), str(out)),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + DEADLINE_S
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                pytest.fail(f"the gloo mesh did not finish in {DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return out, [torch.load(out / f"{r}.pt") for r in range(WORLD)]


@pytest.mark.parametrize("backend", ["halo", "all_gather"])
@pytest.mark.parametrize("group", ["world", "pair"])
def test_group_cycle_equals_stacked(group_results, group, backend):
    d = WORLD if group == "world" else 2
    want = _cycles(StackedShards(d))[backend]
    ranks = [[0, 1, 2, 3]] if d == WORLD else [[0, 1], [2, 3]]
    for members in ranks:
        got = [group_results[1][r][group][backend] for r in members]
        for g in got:
            for a, b in zip(g[:5], want[:5]):
                assert a.dtype == b.dtype and torch.equal(a, b)
        assert sum(g[5] for g in got) == want[5] > 0


def test_run_fl_auto_mesh_in_a_group(group_results, tmp_path):
    """Every rank reports the single-device run's losses and accuracies,
    and the checkpoint the group wrote holds its rows bit for bit."""
    out, results = group_results
    want = run_fl(FLConfig(**FEMNIST_RUN, ckpt_dir=str(tmp_path)),
                  device="cpu")
    for r in results:
        assert r["run_fl"] == (want.round_losses, want.eval_accs)
    got, flat = load_fl_checkpoint(str(out / "ckpt")), \
        load_fl_checkpoint(str(tmp_path))
    assert got.step == flat.step == FEMNIST_RUN["rounds"]
    np.testing.assert_array_equal(got.w, flat.w)
    assert got.meta == flat.meta
