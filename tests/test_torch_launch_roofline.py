"""`repro_torch.launch.roofline` against `repro.launch.roofline` on the
CPU: every analytic function equal float for float for every arch and
applicable shape; `roofline_row`, `table` and `markdown_table` equal on
the same synthetic reports; `fl_mesh_report` equal dict for dict for two
archs at D = 1, 2, 4, 8 and ranks 4, 8; the H100 rows and the card
table; and `fl_mesh_fabric_bytes` against the mesh runtime's own layout
and its `fabric_rows_per_round`."""

import dataclasses
import json

import pytest

jax = pytest.importorskip("jax")

from repro import configs as rconfigs  # noqa: E402
from repro.launch import roofline as rroof  # noqa: E402
from repro.launch import specs as rspecs  # noqa: E402

from repro_torch import configs as pconfigs  # noqa: E402
from repro_torch.launch import roofline as proof  # noqa: E402
from repro_torch.launch import specs as pspecs  # noqa: E402

ARCHS = pconfigs.ARCH_IDS
FEMNIST_T = 1_280_478


def _pairs(arch):
    pcfg, rcfg = pconfigs.get_config(arch), rconfigs.get_config(arch)
    for name, shape in pspecs.SHAPES.items():
        if pspecs.shape_applicable(pcfg, shape)[0]:
            yield pcfg, rcfg, shape, rspecs.SHAPES[name]


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_model_equals_the_reference(arch):
    for pcfg, rcfg, ps, rs in _pairs(arch):
        for kw in ({}, {"include_unembed": False}, {"last_only": True}):
            assert proof.forward_flops(pcfg, ps, **kw) == \
                rroof.forward_flops(rcfg, rs, **kw)
        for remat in (True, False):
            assert proof.train_flops(pcfg, ps, remat=remat) == \
                rroof.train_flops(rcfg, rs, remat=remat)
        for fn in ("decode_flops", "analytic_flops", "analytic_bytes",
                   "model_flops_6nd"):
            assert getattr(proof, fn)(pcfg, ps) == \
                getattr(rroof, fn)(rcfg, rs), (fn, ps.name)


def _reports(meshes):
    """Synthetic dry-run reports: ok, skipped and error rows."""
    out = []
    for i, arch in enumerate(("yi-9b", "granite_moe_1b", "mamba2_370m",
                              "zamba2_1p2b", "gemma3_27b")):
        for j, shape in enumerate(pspecs.SHAPES):
            mesh = meshes[(i + j) % len(meshes)]
            rep = {"arch": arch, "shape": shape, "mesh": mesh,
                   "status": "ok",
                   "cost": {"flops": 1.5e12 * (i + 1) + j},
                   "collectives": {"total_bytes": 3.0e8 * j + 7 * i}}
            if (i + j) % 5 == 3:
                rep = {"arch": arch, "shape": shape, "mesh": mesh,
                       "status": "skipped", "reason": "quadratic " * 40}
            elif (i + j) % 7 == 6:
                rep = {"arch": arch, "shape": shape, "mesh": mesh,
                       "status": "error", "error": "RuntimeError: x"}
            out.append(rep)
    return out


def test_rows_and_table_equal_the_reference(tmp_path):
    reps = _reports(("single", "multi"))
    prow = [proof.roofline_row(r) for r in reps]
    rrow = [rroof.roofline_row(r) for r in reps]
    assert [dataclasses.asdict(p) for p in prow] == \
        [dataclasses.asdict(r) for r in rrow]
    assert proof.markdown_table(prow) == rroof.markdown_table(rrow)
    for k, r in enumerate(reps):
        (tmp_path / f"{k:02d}.json").write_text(json.dumps(r))
    assert proof.load_reports(tmp_path) == rroof.load_reports(tmp_path)
    assert [p.as_dict() for p in proof.table(tmp_path)] == \
        [r.as_dict() for r in rroof.table(tmp_path)]
    assert proof.main([str(tmp_path)]) == 0
    assert proof.main([str(tmp_path / "none")]) == 1


def test_h100_rows_take_the_card_rates():
    for rep in _reports(("h100", "h100_fl2")):
        row = proof.roofline_row(rep)
        if rep["status"] != "ok":
            continue
        cfg = pconfigs.get_config(rep["arch"])
        shape = pspecs.SHAPES[rep["shape"]]
        assert row.compute_s == proof.analytic_flops(cfg, shape) / 989e12
        assert row.memory_s == proof.analytic_bytes(cfg, shape) / 3.35e12
        assert row.collective_s == rep["collectives"]["total_bytes"] / 900e9
        assert row.flops_measured_raw == rep["cost"]["flops"]
    assert proof.CHIPS["h100"] == proof.CHIPS["h100_fl2"] == 1


def test_card_table():
    """`chip_smoke.py` reads these rows; the H100 SXM's are the data
    sheet's, and a bound is the larger of its two times."""
    assert proof.card_rates("NVIDIA H100 80GB HBM3") == (3.35e12, 67e12,
                                                         "H100")
    assert proof.bf16_peak("NVIDIA H100 80GB HBM3") == 989e12
    assert proof.card_rates("NVIDIA H100 NVL")[2] == "H100 NVL"
    assert proof.card_rates("NVIDIA H200")[:2] == (4.8e12, 67e12)
    assert proof.card_rates("something else")[2] == "H100 SXM (assumed)"
    cfg = pconfigs.get_config("yi_9b")
    shape = pspecs.InputShape("prefill", "prefill", 2048, 4)
    b = proof.bound_ms(cfg, shape, card="NVIDIA H100 80GB HBM3")
    assert b["compute_ms"] == proof.analytic_flops(cfg, shape) / 989e12 * 1e3
    assert b["memory_ms"] == proof.analytic_bytes(cfg, shape) / 3.35e12 * 1e3
    assert b["bound_ms"] == max(b["compute_ms"], b["memory_ms"])
    assert b["bound_by"] == "operations"


@pytest.mark.parametrize("arch", ["mamba2-370m", "gemma3-27b"])
@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_fl_mesh_report_equals_the_reference(arch, d):
    for rank in (4, 8):
        assert proof.fl_mesh_report(arch, num_shards=d, rank=rank) == \
            rroof.fl_mesh_report(arch, num_shards=d, rank=rank)


def test_fl_mesh_report_gemma3_d8_rank8_and_table():
    rep = proof.fl_mesh_report("gemma3-27b", num_shards=8, rank=8)
    assert (rep["t_full"], rep["t_lora"]) == (27_008_319_744, 58_990_816)
    assert not rep["full"]["fits"] and rep["lora"]["fits"]
    archs = ["yi-9b", "granite-moe-1b-a400m"]
    assert proof.fl_mesh_table(archs, num_shards=4) == \
        rroof.fl_mesh_table(archs, num_shards=4)


def test_fabric_bytes_convert_the_report_to_the_runtime_count():
    """gaia at D = 1, 2, 4, 8: the report prices one device (halo_rows;
    (D - 1) * per for all_gather); the mesh runtime counts every shard
    (D * halo_rows; D * rows_padded) -- 0 / 8 / 16 / 72 and 11 / 24 / 48 /
    128 rows -- at the same layout `make_mesh_runtime` builds."""
    from repro_torch.core.delay import FEMNIST
    from repro_torch.core.timing import multigraph_timing_plan
    from repro_torch.fl import dpasgd
    from repro_torch.fl.gossip import fabric_rows_per_round
    from repro_torch.fl.mesh import make_mesh_runtime
    from repro_torch.fl.runtime import make_flat_runtime
    from repro_torch.networks import get_network
    import torch

    net = get_network("gaia")
    plan, _, _ = dpasgd.multigraph_plan(
        net, multigraph_timing_plan(net, FEMNIST))
    rt = make_flat_runtime(plan, {"w": torch.empty(FEMNIST_T)},
                           net.num_silos)
    rows = {"halo": (0, 8, 16, 72), "all_gather": (11, 24, 48, 128)}
    for k, d in enumerate((1, 2, 4, 8)):
        rep = proof.fl_mesh_report("mamba2-370m", num_shards=d)
        mrt = make_mesh_runtime(rt, d, device="cpu")
        assert rep["per_shard_rows"] == mrt.per_rows
        assert rep["edges_per_shard"] == mrt.edges_per_shard
        assert rep["halo_rows"] == mrt.halo.halo_rows
        for backend, want in rows.items():
            got = proof.fl_mesh_fabric_bytes(rep, backend, FEMNIST_T)
            assert got == want[k] * FEMNIST_T * 4
            assert got == fabric_rows_per_round(
                backend, halo_rows=mrt.halo.halo_rows, num_shards=d,
                rows_padded=mrt.mspec.rows_padded) * rt.spec.size * 4
            assert proof.fl_mesh_fabric_bytes(rep, backend) == \
                want[k] * rep["t_full"] * 4
        # the report's own per-device figures are left as they are
        per = rep["full"]["collective_bytes_per_round"]
        assert per["halo"] == rep["halo_rows"] * rep["t_full"] * 4
        assert per["all_gather"] == (d - 1) * rep["per_shard_rows"] * \
            rep["t_full"] * 4
