"""The collective counter (`repro_torch.launch.hlo_analysis`) and what it
reads: k sharded products in a loop count k times their operand bytes
(an all-gather counts the local shard it sends); point-to-point sends
count as collective-permute over their mesh axis. On the sharded dry run
(`--debug` multi, one layer) a weak FL round (gossip=False) moves no byte
over "pod" and fewer bytes in all than a strong one (the reference's
`test_dryrun_fl_weak_round_has_no_pod_collective`). `fl8`'s dry states
order their pod bytes overlay > half > isolated = 0, and equal the run
path's `bytes_moved` under the conversion its docstring states:
pod_permute_bytes / shard_bytes == bytes_per_round / (8 * replica_bytes)
== the active directions."""

import dataclasses
import json

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate

from repro_torch.configs import get_config, reduce
from repro_torch.launch import dryrun, fl8, hlo_analysis
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import (GroupSilos, StackedSilos, fake_world,
                                     make_debug_mesh)
from _torch_fl_parity import one_thread  # noqa: F401


@pytest.mark.parametrize("k", [1, 3, 5])
def test_loop_of_sharded_products_counts_k_times(k):
    """x (8, 16) split over its columns times w (16, 12) split over its
    rows: each product is a partial sum, and its reduction to a replica
    an all-reduce of this rank's (8, 12) fp32 product, counted once per
    trip."""
    with fake_world(4):
        mesh = make_debug_mesh((4,), ("model",), device_type="cpu")
        x = sh.shard_of(torch.ones(8, 16), mesh, sh.P(None, "model"))
        w = sh.shard_of(torch.ones(16, 12), mesh, sh.P("model", None))
        counter = hlo_analysis.CollectiveCounter(mesh)
        with counter:
            for _ in range(k):
                (x @ w).redistribute(mesh, [Replicate()])
        st = counter.stats()
    assert st.count_by_kind == {"all-reduce": k}
    assert st.bytes_by_kind == {"all-reduce": k * 8 * 12 * 4}
    assert st.total_bytes == k * 8 * 12 * 4
    assert st.bytes_by_axis == {"model": k * 8 * 12 * 4}
    assert len(st.details) == k
    assert hlo_analysis.while_trip_counts() == {}


def test_all_gather_counts_the_local_shard():
    with fake_world(8):
        mesh = make_debug_mesh((2, 4), ("data", "model"), device_type="cpu")
        x = sh.shard_of(torch.ones(6, 32), mesh, sh.P(None, "model"))
        with hlo_analysis.CollectiveCounter(mesh) as counter:
            x.redistribute(mesh, [Replicate(), Replicate()])
        st = counter.stats().summary()
    assert st["by_kind"] == {"all-gather": 6 * 8 * 4}
    assert st["counts"] == {"all-gather": 1}
    assert st["by_axis"] == {"model": 6 * 8 * 4}
    assert set(st) == {"total_bytes", "by_kind", "counts", "by_axis"}


def test_point_to_point_counts_as_collective_permute():
    with fake_world(8):
        mesh = make_debug_mesh((2, 2, 2), ("pod", "data", "model"),
                               device_type="cpu")
        axis = GroupSilos(mesh.get_group("pod"))
        with hlo_analysis.CollectiveCounter(mesh) as counter:
            axis.ppermute({"a": torch.ones(5), "b": torch.ones(2, 3)},
                          [(0, 1), (1, 0)])
        st = counter.stats()
    assert st.bytes_by_kind == {"collective-permute": (5 + 6) * 4}
    assert st.bytes_by_axis == {"pod": (5 + 6) * 4}
    assert not dist.is_initialized()  # the fake world is gone


def test_dry_fl_weak_round_has_no_pod_collective():
    """mamba2-370m x train_4k on the (2, 2, 2) debug mesh, one layer
    (microbatch 1 to keep the trace short): a weak round moves nothing
    over "pod" and fewer bytes in all; a strong one gathers the silos
    over "pod"."""
    kw = dict(layers=1, debug=True, microbatch=1)
    strong = dryrun.dry_pair("mamba2-370m", "train_4k", "h100x512", **kw)
    weak = dryrun.dry_pair("mamba2-370m", "train_4k", "h100x512",
                           gossip=False, **kw)
    assert strong["status"] == weak["status"] == "ok"
    assert weak["mesh_shape"] == [2, 2, 2]
    assert weak["collectives"]["by_axis"].get("pod", 0) == 0
    assert strong["collectives"]["by_axis"]["pod"] > 0
    assert weak["collectives"]["total_bytes"] < \
        strong["collectives"]["total_bytes"]


def test_sharded_dry_pair_reports_rank_zero():
    """yi-9b prefill on the (2, 2) debug mesh: the report's keys, and the
    argument bytes those of rank 0's shards."""
    from repro_torch.launch.specs import batch_shape, params_shape

    cfg = reduce(get_config("yi_9b"))
    shape = dryrun.InputShape("probe", "prefill", 32, 4)
    rep = dryrun.dry_pair(cfg, shape, "h100x256", debug=True)
    assert rep["status"] == "ok", rep.get("error")
    assert rep["collectives"]["total_bytes"] > 0
    with fake_world(4):
        mesh = make_debug_mesh((2, 2), ("data", "model"), device_type="cpu")
        pshape = params_shape(cfg)
        specs = sh.param_specs(cfg, pshape, mesh=mesh)
        want = sum(torch.Size(sh.local_shape(x.shape, mesh, s)).numel()
                   * x.element_size()
                   for x, s in zip(dryrun.meta_leaves(pshape),
                                   _leaves(specs)))
    tokens = batch_shape(cfg, shape)["tokens"]
    want += (tokens.numel() // 2) * tokens.element_size()
    assert rep["memory"]["argument_bytes"] == want


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


@pytest.fixture(scope="module")
def fl8_states():
    """Each state on both paths, for a mamba2 cut to one layer of width 64
    (the conversion does not depend on the size)."""
    cfg = dataclasses.replace(reduce(get_config("mamba2-370m")),
                              num_layers=1, d_model=64)
    axis = StackedSilos(fl8.N_SILOS)
    return {name: (fl8.dry_state(name, cfg, left, right),
                   fl8.run_state(name, cfg, left, right, axis=axis,
                                 device="cpu", rounds=1))
            for name, left, right in fl8.STATES}


def test_fl8_dry_states_order_their_pod_bytes(fl8_states):
    pod = {k: v[0]["pod_permute_bytes"] for k, v in fl8_states.items()}
    assert pod["overlay"] > pod["half"] > pod["isolated"] == 0
    assert fl8_states["isolated"][0]["collectives"]["total_bytes"] == 0
    for dry, _ in fl8_states.values():
        assert dry["status"] == "ok"
        assert set(dry["collectives"]["by_axis"]) <= {"pod"}


@pytest.mark.parametrize("name,directions", [("overlay", 2), ("half", 1),
                                             ("isolated", 0)])
def test_fl8_dry_bytes_convert_to_the_run_paths(fl8_states, name,
                                                directions):
    dry, run = fl8_states[name]
    assert dry["pod_permute_bytes"] == directions * dry["shard_bytes"]
    assert run["bytes_per_round"] == (directions * fl8.N_SILOS
                                      * run["replica_bytes"])
    assert (dry["pod_permute_bytes"] * fl8.N_SILOS * run["replica_bytes"]
            == run["bytes_per_round"] * dry["shard_bytes"])


def test_fl8_dry_cli(capsys, monkeypatch):
    monkeypatch.setattr(fl8, "ARCH", reduce(get_config("mamba2-370m")))
    fl8.main(["--dry"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [r["state"] for r in lines] == ["overlay", "half", "isolated"]
