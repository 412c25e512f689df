"""The port's dry run (`repro_torch.launch.dryrun`) and perf variants on
the CPU: the FLOPs it counts on fake tensors against the analytic model
on the reference's calibration probes (band 0.7-1.6, the reference's own
test's), equal to `FlopCounterMode`'s count; `dry_pair` in its three
modes on both meshes at reduced size with exact argument bytes; the
mesh runtime's per-shard state allocated on fake tensors equal to
`fl_mesh_report`'s state bytes; the CLIs; perf pair B's sharding
variants on the sharded mesh."""

import dataclasses
import json

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config, reduce
from repro_torch.launch import dryrun, perf, roofline
from repro_torch.launch.specs import InputShape, meta_leaves, params_shape
from repro_torch.models import transformer as tf


def _probe_cfg(arch):
    """The reference's calibration probe (`tests/test_dryrun_roofline.py`):
    one layer, a single SSD chunk, the hybrid's block every layer."""
    cfg = reduce(get_config(arch))
    kw = dict(num_layers=1)
    if cfg.uses_ssm:
        kw["ssm_chunk"] = 32
    if cfg.family == "hybrid":
        kw["attn_every"] = 1
    if cfg.global_every:
        kw["global_every"] = 2
    return dataclasses.replace(cfg, **kw)


@pytest.mark.parametrize("arch", ["yi_9b", "granite_moe_1b", "mamba2_370m"])
def test_flops_calibration_band(arch):
    """Counted / analytic within the reference's [0.7, 1.6] (the port
    reads about 1.0); the meter's count is `FlopCounterMode`'s."""
    cfg = _probe_cfg(arch)
    b, s = 2, 32
    pshape = params_shape(cfg)

    def fwd(p, t):
        return tf.forward(p, cfg, t, impl="reference", moe_impl="dense")[0]

    def make_args():
        return dryrun._fake(pshape), torch.empty((b, s), dtype=torch.int32)

    measured = dryrun.measure(fwd, make_args)["cost"]["flops"]
    with FakeTensorMode():
        counter = FlopCounterMode(display=False)
        with counter:
            fwd(*make_args())
    assert measured == counter.get_total_flops()
    analytic = roofline.forward_flops(cfg, InputShape("probe", "prefill",
                                                      s, b))
    if cfg.uses_moe:
        analytic += (6 * b * s * cfg.d_model * cfg.expert_d_ff
                     * (cfg.num_experts - cfg.experts_per_token))
    assert 0.7 < measured / analytic < 1.6, (measured, analytic)


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in meta_leaves(tree))


@pytest.mark.parametrize("mode,mesh", [("train", "h100"),
                                       ("train", "h100_fl2"),
                                       ("prefill", "h100"),
                                       ("decode", "h100")])
def test_dry_pair_runs_with_exact_argument_bytes(mode, mesh):
    """Reduced yi-9b in bf16 (decode caches are bf16): the report's keys,
    status ok, argument bytes exactly the params (stacked per silo on
    h100_fl2), the AdamW moments (fp32) and the int32 batch or the
    caches; the train step's FLOPs about 3-4x the forward's."""
    cfg = dataclasses.replace(reduce(get_config("yi_9b")), dtype="bfloat16")
    shape = InputShape("probe", mode, 32, 4)
    rep = dryrun.dry_pair(cfg, shape, mesh, microbatch=2)
    assert rep["status"] == "ok", rep.get("trace")
    assert rep["collectives"]["total_bytes"] == 0
    assert rep["memory"]["generated_code_bytes"] is None
    assert rep["while_trips"] == {}
    mem = rep["memory"]
    assert mem["temp_bytes"] == mem["peak_bytes"] - mem["argument_bytes"]
    assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
    params = _nbytes(params_shape(cfg))
    numel = sum(x.numel() for x in meta_leaves(params_shape(cfg)))
    silos = 2 if mesh == "h100_fl2" else 1
    if mode == "train":
        want = silos * (params + 2 * 4 * numel) + 2 * 4 * 32 * 4
        fwd = roofline.forward_flops(cfg, shape)
        assert 2.5 < rep["cost"]["flops"] / fwd < 5.0
    elif mode == "prefill":
        want = params + 4 * 32 * 4
    else:
        _, state = dryrun.decode_shapes(cfg, shape)
        want = params + 4 * 1 * 4 + _nbytes(state.caches)
        assert mem["output_bytes"] >= _nbytes(state.caches)
    assert mem["argument_bytes"] == want


def test_dry_pair_skips_and_refuses():
    rep = dryrun.dry_pair("yi-9b", "long_500k")
    assert rep["status"] == "skipped" and "quadratic" in rep["reason"]
    with pytest.raises(ValueError):
        dryrun.dry_pair("yi-9b", "train_4k", "multi")


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_fl_mesh_state_bytes_equal_the_report(d):
    """One shard's w, momentum and padded edge buffers, allocated by
    `init_mesh_state` on fake tensors, for mamba2-370m's full and rank-8
    LoRA rows: exactly `fl_mesh_report`'s state bytes."""
    rep = dryrun.dry_fl_mesh("mamba2-370m", d)
    assert rep["status"] == "ok", rep.get("error")
    want = rep["fl_mesh_report"]
    assert rep["memory"]["state_bytes"] == {
        k: want[k]["state_bytes"] for k in ("full", "lora")}
    fab = rep["collectives"]["full"]["fabric_bytes"]
    assert fab["halo"] == d * want["halo_rows"] * want["t_full"] * 4


def test_dryrun_and_roofline_clis(tmp_path, capsys):
    """mamba2-370m decode on both meshes, cut to one layer, then the
    table."""
    assert dryrun.main(["--arch", "mamba2-370m", "--shape", "decode_32k",
                        "--mesh", "both", "--layers", "1",
                        "--out", str(tmp_path)]) == 0
    reps = [json.loads(p.read_text()) for p in sorted(tmp_path.glob("*"))]
    assert [(r["mesh"], r["status"], r["layers"]) for r in reps] == [
        ("h100", "ok", 1), ("h100_fl2", "ok", 1)]
    capsys.readouterr()
    assert roofline.main([str(tmp_path)]) == 0
    table = capsys.readouterr().out.splitlines()
    assert len(table) == 4 and "| mamba2-370m | decode_32k | h100 | ok" \
        in table[2]


def test_perf_pair_b_skips_the_sharding_variants(tmp_path, capsys):
    """Pair B's sharding variants leave the card mesh, where they would
    be skipped, for the sharded one: B0 on "h100" and on "h100x256", B1
    (no FSDP) and B2 (no FSDP, KV sequence sharded) beside the latter,
    one layer; the roofline table prices the sharded rows with a
    collective term."""
    perf.pair_b(out=tmp_path, layers=1)
    got = {p.stem: json.loads(p.read_text()) for p in tmp_path.glob("*")}
    assert got["B0_base"]["status"] == "ok"
    assert got["B0_base"]["layers"] == 1
    assert got["B0_base"]["mesh"] == "h100"
    for name in ("B0_base_x256", "B1_tp_resident", "B2_kv_seq_shard"):
        assert got[name]["status"] == "ok", got[name].get("error")
        assert got[name]["mesh"] == "h100x256"
        assert got[name]["mesh_shape"] == [16, 16]
        assert got[name]["layers"] == 1
        assert got[name]["hypothesis"]
        assert roofline.roofline_row(got[name]).collective_s > 0
    capsys.readouterr()
    assert roofline.main([str(tmp_path)]) == 0
    table = capsys.readouterr().out
    assert "| gemma3_27b | decode_32k | h100x256 | ok" in table
