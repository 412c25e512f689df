"""The FL round of the sharded program on a real (2, 2, 2) ("pod",
"data", "model") mesh of 8 gloo processes on the CPU: reduced mamba2-370m
cut to one layer, in fp32, two silos with their own parameters stacked on
a leading axis sharded over "pod" (`param_specs(pod_stacked=True)`), one
`make_fl_train_step` round (AdamW 1e-4, each pod's local step on its own
sub-mesh, then the consensus) against the same round unsharded (in rank
0): parameters within 1e-5 relative L2 (all leaves as one vector)
and each leaf within 1e-4 of its own norm (`_torch_sharded.py` says why),
the mean loss within 1e-5 relative. The collective counter on the real
group: a weak round (gossip=False) moves nothing over "pod", a strong one
does. One run of processes, with a deadline.
"""

import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from _torch_sharded import _cfg, _free_port, _leaves, _rel

WORLD = 8
DEADLINE_S = 300
ARCHS = ("mamba2_370m",)
SILOS, B, S = 2, 4, 32


def _worker(rank, port, tmp):
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import configs
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.hlo_analysis import CollectiveCounter
    from repro_torch.launch.mesh import make_debug_mesh, tree_map
    from repro_torch.launch.steps import make_fl_train_step
    from repro_torch.models import shard_ctx
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=WORLD, rank=rank)
    P = sh.P
    try:
        mesh = make_debug_mesh((2, 2, 2), ("pod", "data", "model"),
                               device_type="cpu")
        out = {}
        for arch in ARCHS:
            cfg = _cfg(configs, arch)
            silos = [tf.init_params(cfg, torch.Generator().manual_seed(s),
                                    device="cpu") for s in range(SILOS)]
            params = tree_map(lambda *xs: torch.stack(xs), *silos)
            toks = torch.from_numpy(np.random.default_rng(3).integers(
                0, cfg.vocab_size, (SILOS, B, S + 1)))
            batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
            pspec = sh.param_specs(cfg, params, pod_stacked=True, mesh=mesh)
            bspec = sh.batch_specs("train", multi_pod=True, fl=True,
                                   has_prefix=False)
            res = {}
            with implicit_replication():
                shard_ctx.set_specs(act=P("data", None, None),
                                    channels=P("data", None, "model"),
                                    heads=P("data", None, "model", None),
                                    mesh=mesh)
                for gossip in (True, False):
                    opt = adamw(1e-4)
                    step = make_fl_train_step(cfg, SILOS, opt, gossip=gossip)
                    dparams = sh.shard_tree(params, mesh, pspec)
                    dbatch = {k: sh.shard_of(v, mesh, bspec[k])
                              for k, v in batch.items()}
                    counter = CollectiveCounter(mesh)
                    with counter:
                        l1, p1, _ = step(dparams, opt.init(dparams), dbatch)
                    res[gossip] = (
                        (l1.full_tensor(), sh.gather_tree(p1)),
                        rank == 0 and step(params, opt.init(params),
                                           batch)[:2],
                        counter.stats().summary())
                shard_ctx.clear()
            out[arch] = res
        if rank == 0:
            torch.save(out, f"{tmp}/results.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_fl")
    ctx = mp.start_processes(_worker, args=(_free_port(), str(tmp)),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + DEADLINE_S
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                pytest.fail(f"the sharded FL round did not finish in "
                            f"{DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return torch.load(tmp / "results.pt")


@pytest.mark.parametrize("gossip", [True, False], ids=["strong", "weak"])
@pytest.mark.parametrize("arch", ARCHS)
def test_fl_round_on_pods_equals_unsharded(results, arch, gossip):
    (l1, p1), (l0, p0), _ = results[arch][gossip]
    assert abs(float(l1) - float(l0)) <= 1e-5 * abs(float(l0))
    flat = [torch.cat([x.flatten() for _, x in _leaves(t)]) for t in (p1, p0)]
    assert _rel(*flat) <= 1e-5
    for (name, a), (_, b) in zip(_leaves(p1), _leaves(p0)):
        assert _rel(a, b) <= 1e-4, name


@pytest.mark.parametrize("arch", ARCHS)
def test_weak_round_moves_nothing_over_pods(results, arch):
    strong = results[arch][True][2]
    weak = results[arch][False][2]
    assert weak["by_axis"].get("pod", 0) == 0
    assert strong["by_axis"]["pod"] > 0
    assert weak["total_bytes"] < strong["total_bytes"]
