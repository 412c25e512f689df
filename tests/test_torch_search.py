"""The port's design search (`repro_torch.design.search`) against
`repro.design.search` on the CPU.

The search is numpy on both sides, scored either by the host grid or,
in the port, by the torch device grid (`core/timing_torch.py`) on the
CPU, which is bit for bit the host grid. The reference runs its numpy
backend throughout: its ``"jax"`` backend calls
`jax.experimental.enable_x64`, which jax 0.9 removed.
So scores, pools, best vectors, `SearchResult` rows (all but
``elapsed_s`` and ``backend``) and the CLI's printed lines (all but
wall-clock fields and the backend's name) are equal exactly; the move
operators draw the same numbers from the same generator and leave it in
the same state.

The TTA stage trains: at the CLI's ``--quick`` sizes and lr 0.001 from
the reference's initial row, its TTA fields are exact and its losses
within rtol 1e-5 (lr 0.001 for the reason `test_torch_tta.py` gives).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

from _torch_fl_parity import reference_init, start_port_from  # noqa: E402
from repro.core.delay import WORKLOADS as RWORKLOADS  # noqa: E402
from repro.design import search as rsearch  # noqa: E402
from repro.faults import get_scenario as rget_scenario  # noqa: E402
from repro.faults import scenario_overrides as r_overrides  # noqa: E402
from repro.networks.registry import get_network as rget  # noqa: E402

from repro_torch.core.delay import WORKLOADS as PWORKLOADS  # noqa: E402
from repro_torch.design import batched as pbatched  # noqa: E402
from repro_torch.design import catalog as pcatalog  # noqa: E402
from repro_torch.design import search as psearch  # noqa: E402
from repro_torch.faults import get_scenario, scenario_overrides  # noqa: E402
from repro_torch.networks.registry import get_network as pget  # noqa: E402

HOST = ("elapsed_s", "backend")
POP = dict(rounds=400, max_iters=4, generations=3, pop_size=8, seed=0)


def _both(net="gaia", wl="femnist"):
    """(port net, workload, overlay), (reference net, workload, overlay)."""
    p, pw = pget(net), PWORKLOADS[wl]
    r, rw = rget(net), RWORKLOADS[wl]
    overlay = pcatalog.ring_topology(p, pw).graph
    return (p, pw, overlay), (r, rw, overlay)


def _row(res):
    return {k: v for k, v in res.row().items() if k not in HOST}


def _cands(overlay, seed, count, t_max=8):
    rng = np.random.default_rng(seed)
    e = len(overlay.pairs)
    return [tuple(int(x) for x in rng.integers(1, t_max + 1, e))
            for _ in range(count)]


@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("n,t_max", [(1, 1), (1, 5), (4, 1), (11, 5),
                                     (30, 8)])
def test_move_operators_equal(seed, n, t_max):
    """Every operator, fed the same generator state, returns the same
    child and leaves the generator in the same state, over vectors with
    walls, constants and free coordinates."""
    for k in range(6):
        ref = np.random.default_rng([seed, k])
        vec = tuple(int(x) for x in ref.integers(1, t_max + 1, n))
        partner = tuple(int(x) for x in ref.integers(1, t_max + 1, n))
        if k == 5:
            vec = (t_max,) * n
        for name in ("mutate", "swap", "cross"):
            rp = np.random.default_rng([seed, k, 1])
            rr = np.random.default_rng([seed, k, 1])
            got = psearch.MOVE_OPERATORS[name](rp, vec, partner, t_max)
            want = rsearch.MOVE_OPERATORS[name](rr, vec, partner, t_max)
            assert got == want, name
            assert rp.bit_generator.state == rr.bit_generator.state, name
        assert psearch.mutate_vector(np.random.default_rng(seed), vec,
                                     t_max) == \
            rsearch.mutate_vector(np.random.default_rng(seed), vec, t_max)
        assert psearch._neighbors(vec, t_max) == \
            rsearch._neighbors(vec, t_max)
        assert psearch.strong_fraction(vec) == rsearch.strong_fraction(vec)
    assert tuple(psearch.MOVE_OPERATORS) == tuple(rsearch.MOVE_OPERATORS)
    assert psearch.PAPER_NETWORKS == rsearch.PAPER_NETWORKS


@pytest.mark.parametrize("net", ["gaia", "geant"])
def test_plan_and_scores_equal(net):
    (p, pw, overlay), (r, rw, _) = _both(net)
    cands = _cands(overlay, 3, 12)
    for vec in cands[:3]:
        a = psearch.multiplicity_plan(p, pw, overlay, vec)
        b = rsearch.multiplicity_plan(r, rw, overlay, vec)
        np.testing.assert_array_equal(a.strong, b.strong)
        np.testing.assert_array_equal(a.d0, b.d0)
        np.testing.assert_array_equal(a.cycle_times(500),
                                      b.cycle_times(500))
    got = psearch.score_candidates(p, pw, overlay, cands, 600)
    want = rsearch.score_candidates(r, rw, overlay, cands, 600)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert psearch._seed_vectors(p, pw, overlay, 5) == \
        rsearch._seed_vectors(r, rw, overlay, 5)


@pytest.mark.parametrize("scenario", ["nominal", "churn"])
def test_make_scorer_equal(scenario):
    """`make_scorer` on numpy and on torch (CPU), nominal and under
    churn's observed-delay overrides, against the reference's numpy
    scorer and its `score_candidates`; a second call reuses the
    uploaded rows."""
    (p, pw, overlay), (r, rw, _) = _both()
    kw_p = kw_r = {}
    if scenario != "nominal":
        d0, comp = scenario_overrides(get_scenario(scenario), p, pw,
                                      overlay, 500)
        rd0, rcomp = r_overrides(rget_scenario(scenario), r, rw, overlay,
                                 500)
        np.testing.assert_array_equal(d0, rd0)
        np.testing.assert_array_equal(comp, rcomp)
        kw_p = kw_r = dict(d0_override=d0, comp_override=comp)
    cands = _cands(overlay, 9, 20)
    want = rsearch.make_scorer(r, rw, overlay, rounds=500, backend="numpy",
                               **kw_r)(cands)
    np.testing.assert_array_equal(
        want, rsearch.score_candidates(r, rw, overlay, cands, 500, **kw_r))
    for backend in ("numpy", "torch"):
        fn = psearch.make_scorer(p, pw, overlay, rounds=500,
                                 backend=backend, device="cpu", **kw_p)
        np.testing.assert_array_equal(fn(cands), want)
        np.testing.assert_array_equal(fn(cands[:5]), want[:5])
        assert fn([]).shape == (0,)
    with pytest.raises(ValueError, match="backend"):
        pbatched.CandidateScorer(p, pw, overlay, rounds=10, backend="jax")


@pytest.mark.parametrize("floor", [True, False])
def test_search_design_equal(floor):
    (p, pw, _), (r, rw, _) = _both()
    for backend in ("numpy", "torch"):
        got, gpool = psearch.search_design_pool(
            p, pw, rounds=300, max_iters=3, density_floor=floor,
            backend=backend, device="cpu")
        want, wpool = rsearch.search_design_pool(
            r, rw, rounds=300, max_iters=3, density_floor=floor,
            backend="numpy")
        assert _row(got) == _row(want)
        assert got.backend == backend and got.engine == "hill"
        assert gpool == wpool
    one = psearch.search_design(p, pw, rounds=300, max_iters=3,
                                density_floor=floor)
    assert _row(one) == _row(want)


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_population_search_equal(backend):
    (p, pw, _), (r, rw, _) = _both()
    got, gpool = psearch.population_search(p, pw, backend=backend,
                                           device="cpu", **POP)
    want, wpool = rsearch.population_search(r, rw, backend="numpy", **POP)
    assert _row(got) == _row(want)
    assert gpool == wpool
    assert (got.engine, got.backend) == ("population", backend)
    assert got.best_mean_ms <= got.hill_best_ms <= got.paper_mean_ms


def test_frontiers_equal():
    """`tta_frontier` / `diverse_frontier` on the reference tests' pool
    and on a scored pool."""
    pool = {(1, 1): 10.0, (1, 2): 8.0, (2, 1): 9.0, (2, 2): 7.0,
            (2, 3): 6.5}
    for k in range(6):
        for fn in ("tta_frontier", "diverse_frontier"):
            assert getattr(psearch, fn)(pool, (2, 3), k) == \
                getattr(rsearch, fn)(pool, (2, 3), k)
    assert psearch.diverse_frontier(pool, (2, 3), 3) == [(2, 2), (1, 2),
                                                        (1, 1)]
    (p, pw, _), _ = _both()
    res, scored = psearch.search_design_pool(p, pw, rounds=300, max_iters=3)
    for k in (1, 3, 8):
        for fn in ("tta_frontier", "diverse_frontier"):
            assert getattr(psearch, fn)(scored, res.paper_mults, k) == \
                getattr(rsearch, fn)(scored, res.paper_mults, k)


def test_search_design_tta_equal(monkeypatch):
    """The two-stage search at the CLI's --quick sizes (population
    engine, top 1, 12 training rounds, 32 samples, batch 8), lr 0.001,
    both packages from the reference's initial row: stage 1 and the
    winner exact, each trained candidate's TTA fields exact and its
    losses within rtol 1e-5."""
    (p, pw, _), (r, rw, _) = _both()
    kw = dict(rounds=800, max_iters=6, top_k=1, train_rounds=12,
              samples_per_silo=32, batch_size=8, lr=0.001, seed=0,
              engine="population", pop_size=12, generations=4)
    start_port_from(monkeypatch, "femnist_cnn",
                    reference_init("femnist_cnn", 11, seed=0))
    got = psearch.search_design_tta(p, pw, backend="torch", device="cpu",
                                    **kw)
    want = rsearch.search_design_tta(r, rw, backend="numpy", **kw)
    assert _row(got.stage1) == _row(want.stage1)
    for f in ("train_rounds", "paper_tta_s", "best_mults", "best_tta_s",
              "best_mean_cycle_ms"):
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_allclose(got.target_loss, want.target_loss, rtol=1e-5)
    assert len(got.candidates) == len(want.candidates) == 2
    for a, b in zip(got.candidates, want.candidates):
        for f in ("name", "reached_round", "tta_s", "mean_cycle_ms",
                  "total_time_s", "density", "rounds"):
            assert getattr(a, f) == getattr(b, f), f
        np.testing.assert_allclose(a.final_loss, b.final_loss, rtol=1e-5)
        assert abs(a.final_acc - b.final_acc) <= 1 / 512 + 1e-12
    assert got.best_tta_s <= got.paper_tta_s
    row = got.row()
    assert row["objective"] == "tta" and row["stage1"]["backend"] == "torch"


def _strip(text, backend):
    """The CLI's lines without the wall-clock column (the table's last,
    eval/s) and the backend's name."""
    out = []
    for line in text.splitlines():
        if line.startswith("gaia"):
            line = line[:-8]
        out.append(line.replace(f"({backend} grid)", "(grid)"))
    return out


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("engine", ["population", "hill"])
def test_cli_equal(capsys, backend, engine):
    base = ["--networks", "gaia", "--workloads", "femnist", "--rounds",
            "300", "--max-iters", "2", "--pop-size", "6", "--generations",
            "2", "--engine", engine]
    assert psearch.main(base + ["--backend", backend, "--device",
                                "cpu"]) == 0
    got = capsys.readouterr().out
    assert rsearch.main(base + ["--backend", "numpy"]) == 0
    want = capsys.readouterr().out
    assert _strip(got, backend) == _strip(want, "numpy")
    assert f"{engine} search ({backend} grid) matched or beat" in got


def test_cli_scenarios_and_json(capsys, tmp_path):
    base = ["--networks", "gaia", "--workloads", "femnist", "--rounds",
            "200", "--max-iters", "2", "--device", "cpu"]
    out = tmp_path / "rows.json"
    assert psearch.main(base + ["--scenario", "drift", "--json",
                                str(out)]) == 0
    got = capsys.readouterr().out
    assert rsearch.main(base[:-2] + ["--scenario", "drift", "--backend",
                                     "numpy"]) == 0
    want = capsys.readouterr().out
    assert _strip(got, "torch")[:-2] == _strip(want, "numpy")[:-1]
    assert "matched or beat" in got and out.exists()
    with pytest.raises(ValueError, match="unknown scenario"):
        psearch.main(base + ["--scenario", "bogus"])
    with pytest.raises(SystemExit):
        psearch.main(base + ["--backend", "jax"])
