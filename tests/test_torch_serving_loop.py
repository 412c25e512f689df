"""The port's regional fleet, traffic sweep and serving CLI on the CPU,
held against `repro.serving` on one checkpoint that the reference's
`run_reduced_fl` writes at `tests/test_serving_loop.py`'s TINY (reduced
mamba2-370m, 6 gaia silos, 3 rounds, checkpoints at steps 2 and 3).
The port reads it with its own checkpoint reader: the same regions and
silos, region variants bit-equal to the reference's, the same arrival
traces and the same load summaries; then the reference's fleet
invariants on the port alone, and `python -m repro_torch.serving`.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.fl import flat as rflat  # noqa: E402
from repro.launch.train import TrainConfig, run_reduced_fl  # noqa: E402
from repro.serving import RegionalFleet as RRegionalFleet  # noqa: E402
from repro.serving import TrafficConfig as RTrafficConfig  # noqa: E402
from repro.serving import generate_requests as rgenerate  # noqa: E402
from repro.serving import sweep_loads as rsweep  # noqa: E402

from repro_torch.checkpoint import FLCheckpoint, load_fl_checkpoint  # noqa: E402
from repro_torch.fl import flat as pflat  # noqa: E402
from repro_torch.networks.registry import get_network  # noqa: E402
from repro_torch.obs import TraceRecorder, validate_trace, write_trace  # noqa: E402
from repro_torch.obs.__main__ import validate_bench_rows  # noqa: E402
from repro_torch.serving import (REGION_ANCHORS, RegionalFleet,  # noqa: E402
                                 TrafficConfig, generate_requests,
                                 nearest_region, simulate, sweep_loads)
from repro_torch.serving import traffic  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = dict(arch="mamba2-370m", network="gaia", silos=6, rounds=3, t=2,
            seq_len=16, batch_size=2)
LOADS = [20.0, 60.0, 120.0]
CFG = dict(seed=0, duration_ms=400.0, step_ms=10.0)


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_ckpt")
    out = run_reduced_fl(TrainConfig(**TINY, ckpt_dir=str(d), ckpt_every=2))
    assert out["ckpt_steps"] == [2, 3]
    return str(d)


@pytest.fixture(scope="module")
def fleets(ckpt_dir):
    """(port fleet on the CPU, reference fleet), both at the latest step."""
    return (RegionalFleet.from_checkpoint(ckpt_dir, max_slots=4, max_seq=64,
                                          device="cpu"),
            RRegionalFleet.from_checkpoint(ckpt_dir, max_slots=4,
                                           max_seq=64))


@pytest.fixture(scope="module")
def sweeps(fleets):
    """Each package's `sweep_loads` at LOADS, with the tokens each region
    engine served at the last load."""
    out = []
    for fleet, cfg in zip(fleets, (TrafficConfig(**CFG),
                                   RTrafficConfig(**CFG))):
        res = (rsweep if isinstance(fleet, RRegionalFleet) else
               sweep_loads)(fleet, cfg, LOADS)
        toks = {r: [q.output for q in v.engine.completed]
                for r, v in fleet.regions.items()}
        out.append((res, toks))
    return out


# ---------------------------------------------------------------------------
# the port's fleet against the reference's
# ---------------------------------------------------------------------------

def test_fleet_regions_and_routing_match_reference(fleets):
    port, ref = fleets
    assert list(port.regions) == list(ref.regions)
    assert {r: v.silo_indices for r, v in port.regions.items()} == \
        {r: v.silo_indices for r, v in ref.regions.items()}
    assert port.ckpt.step == ref.ckpt.step == 3
    assert port.staleness_lag_ms == ref.staleness_lag_ms == 0.0
    assert port.region_names == ref.region_names
    for lat in range(-80, 81, 20):
        for lon in range(-180, 180, 30):
            assert port.route(lat, lon) == ref.route(lat, lon)
    assert port.staleness_ms(12.5) == ref.staleness_ms(12.5)


def test_region_variants_bit_equal_to_reference(fleets):
    port, ref = fleets
    for rname, reg in ref.regions.items():
        rp = reg.engine.params
        want = np.asarray(rflat.ravel(rflat.make_flat_spec(rp), rp))
        pp = port.regions[rname].engine.params
        got = pflat.ravel(pflat.make_flat_spec(pp), pp).numpy()
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


def test_older_step_records_the_same_staleness(ckpt_dir):
    port = RegionalFleet.from_checkpoint(ckpt_dir, step=2, max_slots=2,
                                         max_seq=64, device="cpu")
    ref = RRegionalFleet.from_checkpoint(ckpt_dir, step=2, max_slots=2,
                                         max_seq=64)
    assert port.ckpt.step == ref.ckpt.step == 2
    assert port.staleness_lag_ms == ref.staleness_lag_ms > 0.0
    assert port.staleness_ms(10.0) == pytest.approx(
        port.staleness_lag_ms + 10.0)


@pytest.mark.parametrize("load", LOADS)
def test_generate_requests_match_reference(fleets, load):
    port, ref = fleets
    got = generate_requests(port, TrafficConfig(**CFG), load)
    want = rgenerate(ref, RTrafficConfig(**CFG), load)
    fields = ("rid", "site", "region", "t_gen", "net_ms", "t_submit",
              "t_done", "prompt", "new_tokens", "staleness_ms")
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert {f: getattr(a, f) for f in fields} == \
            {f: getattr(b, f) for f in fields}


def test_sweep_summaries_and_tokens_match_reference(sweeps):
    (port, ptoks), (ref, rtoks) = sweeps
    assert [r.summary for r in port] == [r.summary for r in ref]
    assert [r.load for r in port] == [r.load for r in ref] == LOADS
    # the tokens the two packages' engines served at the highest load
    assert ptoks == rtoks and sum(map(len, ptoks.values())) > 0


def test_lora_delta_checkpoint_raises(fleets):
    """A `lora_delta` checkpoint without the port's ``base_init`` (as the
    reference's trainer writes one: its base is drawn from
    `jax.random.PRNGKey(seed + 1)`) cannot be rebuilt by the port."""
    port = fleets[0]
    ckpt = FLCheckpoint(step=1, w=port.ckpt.w[:, :64],
                        meta=dict(port.meta, params_kind="lora_delta",
                                  lora_rank=4))
    with pytest.raises(ValueError, match="jax.random"):
        RegionalFleet.from_checkpoint(ckpt, device="cpu")


def test_malformed_checkpoints_raise_as_the_reference(fleets):
    port = fleets[0]
    short = FLCheckpoint(step=1, w=port.ckpt.w[:, :-1], meta=port.meta)
    with pytest.raises(ValueError, match="expects"):
        RegionalFleet.from_checkpoint(short, device="cpu")
    meta = {k: v for k, v in port.meta.items() if k != "arch"}
    with pytest.raises(ValueError, match="arch"):
        RegionalFleet.from_checkpoint(
            FLCheckpoint(step=1, w=port.ckpt.w, meta=meta), device="cpu")
    with pytest.raises(ValueError, match="params_kind"):
        RegionalFleet.from_checkpoint(
            FLCheckpoint(step=1, w=port.ckpt.w,
                         meta=dict(port.meta, params_kind="nope")),
            device="cpu")


def test_checkpoint_reader_reads_the_reference_rows(ckpt_dir, fleets):
    ckpt = load_fl_checkpoint(ckpt_dir)
    assert ckpt.w.shape == (TINY["silos"], fleets[1].ckpt.w.shape[1])
    np.testing.assert_array_equal(ckpt.w, fleets[1].ckpt.w)


# ---------------------------------------------------------------------------
# the reference's fleet and traffic invariants, on the port
# ---------------------------------------------------------------------------

def test_region_partition_and_routing(fleets):
    fleet = fleets[0]
    idxs = sorted(i for r in fleet.regions.values()
                  for i in r.silo_indices)
    assert idxs == list(range(TINY["silos"]))
    assert set(fleet.regions) <= set(REGION_ANCHORS)
    net = get_network("gaia")
    for rname, reg in fleet.regions.items():
        for i in reg.silo_indices:
            s = net.silos[i]
            assert fleet.route(s.lat, s.lon) == rname
            assert nearest_region(s.lat, s.lon) == rname


def test_traffic_deterministic_replay(fleets):
    fleet, cfg = fleets[0], TrafficConfig(**CFG)
    a = simulate(fleet, cfg, 60.0)
    b = simulate(fleet, cfg, 60.0)
    assert [(r.t_gen, r.site, r.prompt, r.t_done) for r in a.requests] \
        == [(r.t_gen, r.site, r.prompt, r.t_done) for r in b.requests]
    assert a.summary == b.summary


def test_loads_nest_and_p99_monotone(fleets, sweeps):
    fleet, cfg = fleets[0], TrafficConfig(**CFG)
    traces = {ld: generate_requests(fleet, cfg, ld) for ld in LOADS}
    keys = {ld: {(r.t_gen, r.site) for r in traces[ld]} for ld in LOADS}
    assert keys[20.0] <= keys[60.0] <= keys[120.0]
    by_key = {(r.t_gen, r.site): (r.prompt, r.new_tokens, r.region)
              for r in traces[120.0]}
    for ld in (20.0, 60.0):
        for r in traces[ld]:
            assert by_key[(r.t_gen, r.site)] == \
                (r.prompt, r.new_tokens, r.region)
    p99 = [r.summary["p99_ms"] for r in sweeps[0][0]]
    assert all(a <= b for a, b in zip(p99, p99[1:])), p99


def test_drain_and_utilization_invariants(fleets):
    fleet = fleets[0]
    res = simulate(fleet, TrafficConfig(**CFG), 120.0)
    s = res.summary
    assert s["completed"] == s["arrived"] > 0
    assert 0.0 < s["util"] <= 1.0
    for reg in fleet.regions.values():  # fully drained after the run
        assert reg.engine.utilization() == 0.0
        assert not reg.engine.queue
    for r in res.requests:
        assert r.t_done >= r.t_submit >= r.t_gen
        assert r.e2e_ms >= 2 * r.net_ms  # both WAN legs are paid
        assert r.staleness_ms >= fleet.staleness_lag_ms


def test_request_spans_export_and_validate(fleets, tmp_path):
    fleet = fleets[0]
    rec = TraceRecorder()
    simulate(fleet, TrafficConfig(**CFG), 60.0, recorder=rec)
    assert rec.serve_events
    obj = write_trace(str(tmp_path / "serve.json"), rec)
    assert validate_trace(obj) == []
    spans = [e for e in obj["traceEvents"]
             if e.get("cat") == "serve" and e["ph"] == "X"]
    assert len(spans) == len(rec.serve_events)
    assert {e["args"]["region"] for e in spans} <= set(fleet.regions)


def test_bench_rows_merge_into_the_port_bench_file(fleets, sweeps, tmp_path):
    assert traffic.write_bench_json.__defaults__ == (
        "BENCH_torch_serving.json",)
    path = tmp_path / "BENCH_torch_serving.json"
    path.write_text(json.dumps([{"name": "other/row", "us_per_call": 1.0}]))
    rows = traffic.bench_rows(sweeps[0][0], fleets[0])
    traffic.write_bench_json(rows, path=path)
    got = json.loads(path.read_text())
    assert validate_bench_rows(got) == []
    assert [r["name"] for r in got] == ["other/row", "serving/fleet"] + [
        f"serving/load_{ld:g}rps" for ld in LOADS]


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _cli(*args, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.serving",
                           *args], capture_output=True, text=True,
                          timeout=600, env=env, cwd=cwd)


def test_cli_serves_a_checkpoint_end_to_end(ckpt_dir, sweeps, tmp_path):
    bench, trace = tmp_path / "BENCH_torch_serving.json", tmp_path / "t.json"
    r = _cli("--skip-train", "--ckpt-dir", ckpt_dir, "--loads", "30,90",
             "--duration-ms", "300", "--bench", str(bench), "--trace",
             str(trace), "--device", "cpu", cwd=tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
    out = json.loads(r.stdout)
    assert set(out) == {"ckpt_dir", "regions", "ckpt_step", "serve",
                        "trace", "bench"}
    assert out["ckpt_step"] == 3 and len(out["serve"]) == 2
    assert all(s["completed"] == s["arrived"] for s in out["serve"])
    rows = json.loads(bench.read_text())
    assert validate_bench_rows(rows) == []
    assert sum("serving/load_" in row["name"] for row in rows) == 2
    assert validate_trace(json.loads(trace.read_text())) == []
    assert not (tmp_path / "BENCH_serving.json").exists()


def test_cli_trains_then_serves_by_default(tmp_path, capsys):
    """With no --skip-train the CLI trains first (`run_reduced_fl` at the
    reference's defaults: mamba2-370m reduced, 6 gaia silos, the
    multigraph, 6 rounds, t 2), checkpoints into --ckpt-dir and serves
    the result; its bench validates."""
    from repro_torch.serving.__main__ import main
    bench, d = tmp_path / "BENCH_torch_serving.json", tmp_path / "ckpt"
    assert main(["--ckpt-dir", str(d), "--loads", "30", "--duration-ms",
                 "300", "--bench", str(bench), "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert set(out) == {"ckpt_dir", "train", "regions", "ckpt_step",
                        "serve", "bench"}
    train = out["train"]
    assert (train["arch"], train["topology"], train["silos"]) == (
        "mamba2-370m", "multigraph", 6)
    assert train["ckpt_steps"] == [6] and out["ckpt_step"] == 6
    assert np.isfinite([train["loss_first"], train["loss_last"]]).all()
    assert sum(len(v) for v in out["regions"].values()) == 6
    assert validate_bench_rows(json.loads(bench.read_text())) == []
    assert load_fl_checkpoint(str(d)).meta["network"] == "gaia"


@pytest.mark.parametrize("args", [
    ("--mesh", "2"), ("--skip-train", "--mesh", "2"),
    ("--skip-train", "--lora-rank", "4")], ids=["train", "mesh", "lora"])
def test_cli_refuses_to_train(ckpt_dir, tmp_path, args, capsys):
    """--mesh and --lora-rank no longer refuse. With training, --mesh 2
    --lora-rank 4 trains LoRA deltas on two stacked shards and serves the
    `lora_delta` checkpoint it wrote; with --skip-train the flags are
    ignored, as the reference's CLI ignores them, and ``ckpt_dir`` is
    served as it is."""
    from repro_torch.serving.__main__ import main
    train = args[0] != "--skip-train"
    d = str(tmp_path / "trained") if train else ckpt_dir
    extra = ("--lora-rank", "4", "--rounds", "2", "--silos", "3") \
        if train else ()
    assert main([*args, *extra, "--ckpt-dir", d, "--loads", "20",
                 "--duration-ms", "100", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert ("train" in out) == train
    meta = load_fl_checkpoint(d).meta
    if train:
        assert out["train"]["ckpt_steps"] == [2] and out["ckpt_step"] == 2
        assert np.isfinite([out["train"]["loss_first"],
                            out["train"]["loss_last"]]).all()
        assert (meta["params_kind"], meta["lora_rank"]) == ("lora_delta", 4)
    else:
        assert out["ckpt_step"] == 3 and meta["params_kind"] == "full"
    assert out["serve"][0]["completed"] > 0


@pytest.mark.parametrize("flag,value,field", [
    ("--arch", "yi-9b", "arch"), ("--network", "geant", "network"),
    ("--topology", "ring", "topology"), ("--silos", "5", "silos"),
    ("--rounds", "9", "rounds"), ("--t", "3", "t"),
    ("--ckpt-every", "4", "ckpt_every")],
    ids=["--arch", "--network", "--topology", "--silos", "--rounds", "--t",
         "--ckpt-every"])
def test_cli_rejects_the_training_flags(ckpt_dir, flag, value, field,
                                        monkeypatch, capsys):
    """Each of the reference's training flags reaches the `TrainConfig`
    that the CLI trains with (`run_reduced_fl` is captured here, and the
    CLI then serves ``ckpt_dir``); `--t` is not taken for `--trace`."""
    from repro_torch.launch import train
    from repro_torch.serving.__main__ import main
    seen = []

    def capture(cfg, device=None):
        seen.append((cfg, device))
        return {"arch": cfg.arch, "topology": cfg.topology,
                "silos": cfg.silos, "loss_first": 0.0, "loss_last": 0.0,
                "train_seconds": 0.0, "ckpt_steps": [3]}

    monkeypatch.setattr(train, "run_reduced_fl", capture)
    assert main(["--ckpt-dir", ckpt_dir, flag, value, "--loads", "20",
                 "--duration-ms", "100", "--device", "cpu"]) == 0
    (cfg, device), = seen
    assert device == "cpu" and cfg.ckpt_dir == ckpt_dir
    typ = type(getattr(train.TrainConfig(), field))
    assert getattr(cfg, field) == typ(value)
    assert json.loads(capsys.readouterr().out)["ckpt_step"] == 3
