"""The ring gossip round over `launch.mesh.GroupSilos`, one silo per
process of a gloo process group on the CPU, against the same round on
`StackedSilos` in one process: bit-equal in every state, with and
without the kernel path, for the 4-silo ring and for two 2-silo groups
carved out of it (where left and right are the same peer). The ranks'
byte counters add up to the stacked binding's, and `gossip_dense` over
the group's all_gather equals the stacked one.

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

from repro_torch.fl import gossip
from repro_torch.launch.fl8 import STATES, build_step
from repro_torch.launch.mesh import GroupSilos, StackedSilos

WORLD = 4
DEADLINE_S = 120


def _replicas(n, base):
    """n replicas of a mixed bf16 / fp32 nested tree, stacked."""
    rng = np.random.default_rng(base)
    return {
        "blocks": {"w": torch.from_numpy(rng.normal(size=(n, 2, 5, 3)).astype(
            np.float32)).to(torch.bfloat16),
            "scale": torch.from_numpy(rng.normal(size=(n, 2, 5)).astype(
                np.float32))},
        "embed": torch.from_numpy(rng.normal(size=(n, 11)).astype(
            np.float32)).to(torch.bfloat16),
        "ln_f": torch.from_numpy(rng.normal(size=(n, 9)).astype(np.float32)),
    }


def _take(tree, rows):
    if isinstance(tree, dict):
        return {k: _take(v, rows) for k, v in tree.items()}
    return tree[rows]


def _rounds(axis, params, bufs):
    """Every state with and without the kernel, then gossip_dense."""
    out = {}
    for name, left, right in STATES:
        for use_kernel in (False, True):
            axis.bytes_moved = 0
            step = build_step(None, left, right, axis, use_kernel=use_kernel)
            new, nb = step(params, bufs)
            out[(name, use_kernel)] = (new, nb, axis.bytes_moved)
    axis.bytes_moved = 0
    dense = gossip.gossip_dense(params, gossip.ring_matrix(axis.size), axis)
    out["dense"] = (dense, None, axis.bytes_moved)
    return out


def _inputs(n, base=0):
    return _replicas(n, base), {"left": _replicas(n, base + 1),
                                "right": _replicas(n, base + 2)}


def _worker(rank, port, out_dir):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=WORLD, rank=rank)
    try:
        params, bufs = _inputs(WORLD)
        mine = _take(params, rank)
        mine_bufs = {k: _take(v, rank) for k, v in bufs.items()}
        ring4 = _rounds(GroupSilos(), mine, mine_bufs)
        pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
        ring2 = _rounds(GroupSilos(pairs[rank // 2]), mine, mine_bufs)
        torch.save({"ring4": ring4, "ring2": ring2}, f"{out_dir}/{rank}.pt")
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def group_results(tmp_path_factory):
    out = tmp_path_factory.mktemp("gloo")
    ctx = mp.start_processes(_worker, args=(_free_port(), str(out)),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + DEADLINE_S
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                pytest.fail(f"the gloo ring did not finish in {DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(out / f"{r}.pt") for r in range(WORLD)]


def _equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal(a[k], b[k])
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("case", [(s[0], k) for s in STATES
                                  for k in (False, True)] + ["dense"],
                         ids=lambda c: c if isinstance(c, str)
                         else f"{c[0]}-{'kernel' if c[1] else 'plain'}")
@pytest.mark.parametrize("ring", ["ring4", "ring2"])
def test_group_round_equals_stacked(group_results, ring, case):
    n = WORLD if ring == "ring4" else 2
    groups = [list(range(WORLD))] if n == WORLD else [[0, 1], [2, 3]]
    params, bufs = _inputs(WORLD)
    for ranks in groups:
        stacked = _rounds(StackedSilos(n), _take(params, ranks),
                          {k: _take(v, ranks) for k, v in bufs.items()})
        new, nb, moved = stacked[case]
        for i, r in enumerate(ranks):
            g_new, g_nb, _ = group_results[r][ring][case]
            _equal(g_new, _take(new, i))
            if nb is not None:
                for side in ("left", "right"):
                    _equal(g_nb[side], _take(nb[side], i))
        assert sum(group_results[r][ring][case][2] for r in ranks) == moved
