"""The port's LLM trainer (`repro_torch.launch.train.run_reduced_fl`)
against `repro.launch.train.run_reduced_fl`, on the CPU: mamba2-370m at
the defaults (4 gaia silos, the multigraph, t 5) for 6 rounds, a dense
arch (yi-9b), a moe arch (granite-moe) and paligemma (a vlm prefix),
each reduced. The port starts from the reference's initial parameters
(`initial_params` patched to `params_from_reference` of the reference's
`init_fl_state` draw) and paligemma's prefix is the reference's
`synthetic_prefix`; the LM batches are the same numpy stream on both
sides.

Losses within 1e-4 relative; the simulated fields exactly equal;
checkpoints' steps and metadata equal, rows within 5e-4 (fp32, as the
reference's own tests), and each package reads the other's files.
"""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import configs as rconfigs  # noqa: E402
from repro.checkpoint import load_fl_checkpoint as rload  # noqa: E402
from repro.launch import train as rtrain  # noqa: E402
from repro.models import frontends as rfe  # noqa: E402
from repro.models import transformer as rtf  # noqa: E402

from repro_torch.checkpoint import load_fl_checkpoint as pload  # noqa: E402
from repro_torch.fl import dpasgd  # noqa: E402
from repro_torch.kernels.gossip_combine import ops as gc_ops  # noqa: E402
from repro_torch.launch import train as ptrain  # noqa: E402
from repro_torch.launch.mesh import tree_leaves  # noqa: E402
from repro_torch.models import transformer as ptf  # noqa: E402
from repro_torch.obs import validate_trace  # noqa: E402
from repro_torch.serving import RegionalFleet  # noqa: E402
from _torch_fl_parity import one_thread  # noqa: E402,F401

SIM = ("sim_mean_cycle_ms", "sim_total_time_s")
KEYS = {"arch", "topology", "silos", "loss_first", "loss_last", "losses",
        "train_seconds", "sim_mean_cycle_ms", "sim_total_time_s"}


def _reference_start(monkeypatch, arch, silos=4, seed=0):
    """Start the port from the reference trainer's parameters (its
    `init_fl_state` draws from the first of ``silos`` split keys) and,
    for a frontend, the reference's prefix arrays."""
    mcfg = rconfigs.reduce(rconfigs.get_config(arch))
    key = jax.random.split(jax.random.PRNGKey(seed), silos)[0]
    rp = jax.device_get(rtf.init_params(mcfg, key))
    monkeypatch.setattr(ptrain, "initial_params",
                        lambda m, s, d: ptf.params_from_reference(rp, d))
    if mcfg.frontend != "none":
        monkeypatch.setattr(
            ptrain, "synthetic_prefix",
            lambda c, b, seed, device: torch.from_numpy(np.array(
                rfe.synthetic_prefix(mcfg, b, seed=seed))).to(device))


def _same_run(got, want):
    assert set(got) == set(want)
    for k in ("arch", "topology", "silos") + SIM:
        assert got[k] == want[k], k
    assert len(got["losses"]) == len(want["losses"])
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    assert got["loss_first"] == got["losses"][0]
    assert got["loss_last"] == got["losses"][-1]


@pytest.fixture(scope="module")
def mamba_runs(tmp_path_factory):
    """mamba2-370m at the defaults, 6 rounds, checkpoints every 4 and a
    trace, on both packages."""
    d = tmp_path_factory.mktemp("train")
    kw = dict(rounds=6, ckpt_every=4)
    want = rtrain.run_reduced_fl(rtrain.TrainConfig(
        **kw, ckpt_dir=str(d / "ref"), trace=str(d / "ref.json")))
    with pytest.MonkeyPatch.context() as mp:
        _reference_start(mp, "mamba2-370m")
        before = gc_ops.edge_aggregate.launches
        got = ptrain.run_reduced_fl(ptrain.TrainConfig(
            **kw, ckpt_dir=str(d / "port"), trace=str(d / "port.json")),
            device="cpu")
        assert gc_ops.edge_aggregate.launches == before  # CPU
    return got, want, d


def test_defaults_match_reference(mamba_runs):
    got, want, _ = mamba_runs
    _same_run(got, want)
    assert set(got) == KEYS | {"ckpt_dir", "ckpt_steps", "trace"}
    assert got["ckpt_steps"] == want["ckpt_steps"] == [4, 6]
    assert np.isfinite(got["losses"]).all()
    defaults = ptrain.TrainConfig()
    for f in ("arch", "topology", "network", "silos", "rounds", "t",
              "seq_len", "batch_size", "lr", "seed", "ckpt_every",
              "ckpt_keep", "lora_rank", "gossip"):
        assert getattr(defaults, f) == getattr(rtrain.TrainConfig(), f), f


def test_checkpoints_match_reference(mamba_runs):
    """Steps and metadata equal (the loss tail within 1e-4), rows within
    5e-4; each package's reader takes the other's files."""
    _, _, d = mamba_runs
    for step in (4, 6):
        got, want = pload(d / "port", step), rload(str(d / "ref"), step)
        meta, wmeta = dict(got.meta), dict(want.meta)
        np.testing.assert_allclose(meta.pop("loss_tail"),
                                   wmeta.pop("loss_tail"), rtol=1e-4)
        assert meta == wmeta
        assert got.w.shape == want.w.shape and got.w.dtype == np.float32
        np.testing.assert_allclose(got.w, want.w, rtol=5e-4, atol=5e-4)
        cross = rload(str(d / "port"), step)
        np.testing.assert_array_equal(cross.w, got.w)
        assert dict(cross.meta) == dict(got.meta)
        np.testing.assert_array_equal(pload(d / "ref", step).w, want.w)


def test_port_fleet_serves_port_checkpoint(mamba_runs):
    _, _, d = mamba_runs
    fleet = RegionalFleet.from_checkpoint(str(d / "port"), max_slots=2,
                                          max_seq=16, device="cpu")
    assert fleet.ckpt.step == 6 and fleet.meta["arch"] == "mamba2-370m"
    assert sum(len(r.silo_indices) for r in fleet.regions.values()) == 4


def test_trace_validates(mamba_runs):
    """The port's trace is valid, with the reference's host span names
    and its simulated events exactly."""
    _, _, d = mamba_runs
    got = json.loads((d / "port.json").read_text())
    want = json.loads((d / "ref.json").read_text())
    assert validate_trace(got) == []

    def host(obj):
        return sorted(e["name"] for e in obj["traceEvents"]
                      if e.get("pid") == 2 and e["ph"] == "X")

    def sim(obj):
        return [e for e in obj["traceEvents"] if e.get("pid") == 1]

    assert host(got) == host(want)
    assert host(got).count("checkpoint") == 2
    assert sim(got) == sim(want)


@pytest.mark.parametrize("arch", ["yi-9b", "granite-moe-1b-a400m",
                                  "paligemma-3b"])
def test_other_archs_match_reference(monkeypatch, arch):
    kw = dict(arch=arch, rounds=4, silos=3, seq_len=16, batch_size=2)
    want = rtrain.run_reduced_fl(rtrain.TrainConfig(**kw))
    _reference_start(monkeypatch, arch, silos=3)
    got = ptrain.run_reduced_fl(ptrain.TrainConfig(**kw), device="cpu")
    _same_run(got, want)



@pytest.mark.parametrize("arch", ["mamba2-370m", "paligemma-3b"])
def test_mesh_runs_equal_the_legacy_runtime(monkeypatch, tmp_path, arch):
    """`run_reduced_fl(mesh=1)` and `(mesh=2)` (3 silos: one pad row)
    from the reference's start equal the legacy runtime's run, which the
    tests above hold against the reference: losses, the simulated axis,
    checkpoint steps, metadata and rows bit for bit. This holds the mesh
    branch's chunked draws, its LM batch leaves and paligemma's prefix
    broadcast to the legacy per-round path."""
    _reference_start(monkeypatch, arch, silos=3)
    kw = dict(arch=arch, rounds=4, silos=3, seq_len=16, batch_size=2,
              ckpt_every=2)
    runs = {}
    for mesh in (None, 1, 2):
        ck = tmp_path / f"mesh{mesh}"
        runs[mesh] = (ptrain.run_reduced_fl(ptrain.TrainConfig(
            **kw, mesh=mesh, ckpt_dir=str(ck)), device="cpu"), ck)
    want, ck0 = runs[None]
    for mesh in (1, 2):
        got, ck = runs[mesh]
        assert got["losses"] == want["losses"]
        for k in SIM + ("ckpt_steps",):
            assert got[k] == want[k], k
        for step in (2, 4):
            a, b = pload(ck, step), pload(ck0, step)
            assert dict(a.meta) == dict(b.meta)
            np.testing.assert_array_equal(a.w, b.w)

def test_aggregates_every_leaf_through_edge_aggregate(monkeypatch):
    """`fl_round_step` sends every leaf of a round to one
    `refresh_aggregate` call, one segment a leaf (counted here through a
    wrapper: on the CPU the op runs its plain version and launches
    nothing)."""
    calls = []
    real = dpasgd.refresh_aggregate

    def spy(segments):
        calls.append([s.w.shape for s in segments])
        return real(segments)

    monkeypatch.setattr(dpasgd, "refresh_aggregate", spy)
    out = ptrain.run_reduced_fl(ptrain.TrainConfig(rounds=3, silos=3,
                                                   seq_len=16), device="cpu")
    mcfg = ptrain.reduce_cfg(ptrain.get_config("mamba2-370m"))
    leaves = tree_leaves(ptrain.initial_params(mcfg, 0, "cpu"))
    assert len(calls) == 3
    assert all(len(c) == len(leaves) for c in calls)
    assert all(s[0] == 3 for c in calls for s in c)
    assert np.isfinite(out["losses"]).all()


def test_mesh_and_lora_raise(capsys):
    """The reference's refusals stay (lora_rank without a mesh, metrics);
    ``mesh=`` with and without ``lora_rank`` trains (the flat whole-cycle
    runtime on two stacked shards; LoRA's T is its delta's), and so does
    ``--mesh 2 --lora-rank 4`` on the command line."""
    with pytest.raises(ValueError, match="lora_rank requires the mesh"):
        ptrain.run_reduced_fl(ptrain.TrainConfig(lora_rank=4), device="cpu")
    with pytest.raises(ValueError, match="metrics"):
        ptrain.TrainConfig(metrics=object())
    small = dict(rounds=2, silos=3, seq_len=16, batch_size=2)
    full = ptrain.run_reduced_fl(ptrain.TrainConfig(**small, mesh=2),
                                 device="cpu")
    low = ptrain.run_reduced_fl(ptrain.TrainConfig(**small, mesh="auto",
                                                   lora_rank=4), device="cpu")
    for out in (full, low):
        assert set(out) == KEYS and len(out["losses"]) == 2
        assert np.isfinite(out["losses"]).all()
    # a LoRA silo communicates its delta row: a smaller simulated model
    assert low["sim_total_time_s"] < full["sim_total_time_s"]
    assert ptrain.main(["--mesh", "2", "--lora-rank", "4", "--rounds", "2",
                        "--silos", "3", "--seq-len", "16", "--batch-size",
                        "2", "--device", "cpu"]) == 0
    printed = json.loads(capsys.readouterr().out)
    assert set(printed) == KEYS - {"losses"}
    assert printed["loss_first"] == low["loss_first"]


def test_main_prints_the_reference_keys(capsys):
    assert ptrain.main(["--rounds", "2", "--silos", "3", "--seq-len", "16",
                        "--set", "batch_size=2", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert set(out) == KEYS - {"losses"}
    assert out["silos"] == 3 and out["arch"] == "mamba2-370m"
    assert np.isfinite([out["loss_first"], out["loss_last"]]).all()


def test_needs_a_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptrain.run_reduced_fl(ptrain.TrainConfig(rounds=1))
