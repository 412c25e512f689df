"""The port's time-to-accuracy evaluator (`repro_torch.design.evaluate`)
against `repro.design.evaluate` on the CPU, and against the port's own
`run_fl`.

Three multiplicity vectors over gaia's ring overlay (Algorithm 1's at
t = 5, all ones, Algorithm 1's at t = 3) go through `evaluate_frontier`
at the reference oracle's size (10 rounds, 32 samples a silo, batch 8,
seed 3), both packages starting from the reference's initial row. The
simulated-time fields (`mean_cycle_ms`, `total_time_s`) and the
crossing (`reached_round`, `tta_s`) are exactly equal; the smoothed
losses within rtol 1e-5; accuracies within one of the 512 test samples.
Each of the port's candidates equals the port's `run_fl` for its vector
bit for bit, and the frontier builds its cycle function once.

lr is 0.001, as in the `run_fl` parity tests (`test_torch_slice.py`):
per-silo fp32 gradients differ by a few ulps between XLA:CPU's im2col
convolution and `F.conv2d`. At the evaluator's default 0.05 this
untrained CNN amplifies that: the two packages' `run_fl` losses on
these batches are 1.3e-7 apart in round 2 and 9.4e-3 in round 8. At
0.001 they stay within 2.1e-7 over all 10 rounds.

The limits still catch a wrong aggregation at this lr. Each of four
faults planted in `fl/runtime.make_cycle_fn`'s round fails all three
`test_frontier_matches_reference` cases and
`test_attach_tta_matches_reference`: every edge refreshed each round
(final loss 7.1-7.3 % off), buffers never refreshed after round 0
(2.7-6.3 %, `reached_round` off by 1-4), coefficients 1/4 and diagonal
1/2 in place of 1/3 each (4.0 %, `reached_round` off by 1), and the
diagonal term dropped. The rtol is 1e-5.
"""

import dataclasses
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from _torch_fl_parity import reference_init, start_port_from  # noqa: E402
from repro.core.delay import WORKLOADS as RWORKLOADS  # noqa: E402
from repro.core import sweep as rsweep  # noqa: E402
from repro.design import evaluate as revaluate  # noqa: E402

from repro_torch.core import sweep as psweep  # noqa: E402
from repro_torch.core.delay import FEMNIST  # noqa: E402
from repro_torch.core.multigraph import build_multigraph  # noqa: E402
from repro_torch.design import evaluate as pevaluate  # noqa: E402
from repro_torch.design.catalog import ring_topology  # noqa: E402
from repro_torch.fl import dpasgd  # noqa: E402
from repro_torch.fl import runtime as flrt  # noqa: E402
from repro_torch.networks.registry import get_network  # noqa: E402

KW = dict(rounds=10, samples_per_silo=32, batch_size=8, seed=3, lr=0.001)
EXACT = ("name", "network", "dataset", "rounds", "reached_round", "tta_s",
         "mean_cycle_ms", "total_time_s", "density")


def _vector(t):
    net = get_network("gaia")
    overlay = ring_topology(net, FEMNIST).graph
    mg = build_multigraph(net, FEMNIST, overlay, t=t)
    return tuple(int(mg.multiplicity[p]) for p in overlay.pairs)


def _named():
    v5 = _vector(5)
    return [("algorithm1", v5), ("ones", (1,) * len(v5)),
            ("t3", _vector(3))]


@pytest.fixture(scope="module")
def frontiers():
    """(port frontier, reference frontier, cycle functions the port
    built), from the reference's initial row on both sides."""
    built = []
    make = flrt.make_cycle_fn

    def counting(*a, **k):
        built.append(1)
        return make(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        start_port_from(mp, "femnist_cnn",
                        reference_init("femnist_cnn", 11, seed=KW["seed"]))
        mp.setattr(flrt, "make_cycle_fn", counting)
        got = pevaluate.evaluate_frontier("gaia", "femnist", _named(),
                                          device="cpu", **KW)
    ref = revaluate.evaluate_frontier("gaia", "femnist", _named(), **KW)
    return got, ref, len(built)


def _assert_close(got, ref):
    for f in EXACT:
        assert getattr(got, f) == getattr(ref, f), f
    for f in ("final_loss", "target_loss"):
        np.testing.assert_allclose(getattr(got, f), getattr(ref, f),
                                   rtol=1e-5, err_msg=f)
    assert abs(got.final_acc - ref.final_acc) <= 1 / 512 + 1e-12


@pytest.mark.parametrize("k", range(3))
def test_frontier_matches_reference(frontiers, k):
    got, ref, _ = frontiers
    assert len(got) == len(ref) == 3
    _assert_close(got[k], ref[k])
    assert math.isfinite(got[k].final_loss)


def test_frontier_builds_one_cycle_function(frontiers):
    assert frontiers[2] == 1


@pytest.mark.parametrize("k", range(3))
def test_frontier_equals_run_fl(frontiers, monkeypatch, k):
    """Candidate k of the frontier is `run_fl` of its vector (through
    `evaluate_design`) bit for bit: every field but the host seconds."""
    got = frontiers[0][k]
    name, vec = _named()[k]
    start_port_from(monkeypatch, "femnist_cnn",
                    reference_init("femnist_cnn", 11, seed=KW["seed"]))
    one = pevaluate.evaluate_design(
        "gaia", "femnist", multiplicity=vec, name=name,
        target_loss=frontiers[0][0].target_loss, device="cpu", **KW)
    assert dataclasses.replace(one, train_s=0.0) == \
        dataclasses.replace(got, train_s=0.0)


def test_frontier_refuses_mixed_overlays(monkeypatch):
    """Vectors over another overlay cannot share a cycle function."""
    net = get_network("geant")
    geant = tuple(1 for _ in ring_topology(net, FEMNIST).graph.pairs)
    with pytest.raises(ValueError, match="entries"):
        pevaluate.evaluate_frontier("gaia", "femnist",
                                    [("a", _vector(5)), ("b", geant)],
                                    device="cpu", **KW)
    # a second plan whose directed edges are another graph's (the MST's)
    make = dpasgd.make_round_schedule

    def other_graph(topology, net, wl, multiplicity=None, **kw):
        if multiplicity == (2,) * 11:
            return make("mst", net, wl)
        return make(topology, net, wl, multiplicity=multiplicity, **kw)

    monkeypatch.setattr(dpasgd, "make_round_schedule", other_graph)
    with pytest.raises(ValueError, match="edge structure"):
        pevaluate.evaluate_frontier("gaia", "femnist",
                                    [("a", _vector(5)), ("b", (2,) * 11)],
                                    device="cpu", **KW)


def test_smoothing_and_time_to_target_equal_reference():
    rng = np.random.default_rng(4)
    for n in (0, 1, 3, 17):
        losses = rng.normal(size=n) + np.linspace(3, 1, n)
        times = rng.uniform(5, 50, size=n)
        for window in (1, 2, 5):
            got = pevaluate.smoothed_losses(losses, window)
            want = revaluate.smoothed_losses(losses, window)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
            for target in (-1.0, 1.5, 2.0, 10.0):
                assert pevaluate.time_to_target(losses, times, target,
                                                window) == \
                    revaluate.time_to_target(losses, times, target, window)
    assert pevaluate.TTA_WINDOW == revaluate.TTA_WINDOW
    assert pevaluate.WL_TO_DATASET == revaluate.WL_TO_DATASET


def test_attach_tta_matches_reference(monkeypatch):
    """`attach_tta(device="cpu")` fills the multigraph cell's columns as
    the reference's does, and as a direct `evaluate_design` call."""
    kw = dict(topologies=("ring", "multigraph"), networks=("gaia",),
              workloads=("femnist",), num_rounds=64)
    start_port_from(monkeypatch, "femnist_cnn",
                    reference_init("femnist_cnn", 11))
    got = psweep.attach_tta(psweep.run_sweep(psweep.SweepConfig(**kw)),
                            rounds=3, device="cpu")
    ref = rsweep.attach_tta(rsweep.run_sweep(rsweep.SweepConfig(**kw)),
                            rounds=3)
    assert [c.tta_s for c in got] == [c.tta_s for c in ref]
    assert got[0].tta_s is None and math.isfinite(got[1].tta_s)
    np.testing.assert_allclose(got[1].tta_target_loss,
                               ref[1].tta_target_loss, rtol=1e-5)
    assert abs(got[1].tta_final_acc - ref[1].tta_final_acc) <= 1 / 512
    one = pevaluate.evaluate_design("gaia", "femnist", rounds=3,
                                    device="cpu")
    assert (got[1].tta_s, got[1].tta_final_acc, got[1].tta_target_loss) \
        == (one.tta_s, one.final_acc, one.target_loss)
    assert RWORKLOADS["femnist"].name == FEMNIST.name
