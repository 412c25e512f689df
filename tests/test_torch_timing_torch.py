"""The port's device grid (`repro_torch.core.timing_torch`) against the
numpy grid engine, its oracle, on the CPU.

The reference's device grid (`repro.core.timing_jax`) cannot run under
jax 0.9 (it calls `jax.experimental.enable_x64`, which jax 0.9
removed), so the grid is held against the numpy
`timing._grid_recurrence_taus` instead, bit for bit: every op of the
recurrence is an IEEE float64 add, subtract, max or select. The cells
are the paper's whole sweep grid (105 cells, the 15 multigraph cells
on the recurrence axis) at the paper's 6,400 rounds, with per-cell
``(C, E)`` and shared ``(E,)`` delay rows. A `cuda`-marked test repeats
the paper grid on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import sweep, timing, timing_torch
from repro_torch.core.delay import WORKLOADS
from repro_torch.design import batched, catalog
from repro_torch.networks.registry import get_network

ROUNDS = 6400


@pytest.fixture(scope="module")
def paper_grid():
    plans, _ = sweep.build_sweep_plans(sweep.SweepConfig())
    return plans, timing.build_timing_grid(plans)


def _taus(grid, rounds, device):
    return timing_torch.grid_recurrence_taus(
        grid.d0, grid.pair_comp, grid.strong, grid.trans, grid.lone_comp,
        grid.num_states, rounds, device=device)


def _numpy_taus(grid, rounds):
    return timing._grid_recurrence_taus(
        grid.d0, grid.pair_comp, grid.strong, grid.trans, grid.lone_comp,
        grid.num_states, rounds)


def test_paper_cells_bit_equal(paper_grid):
    plans, grid = paper_grid
    assert len(plans) == 105 and len(grid.rec_rows) == 15
    got = _taus(grid, ROUNDS, "cpu")
    assert got.dtype == np.float64 and got.shape == (15, ROUNDS)
    np.testing.assert_array_equal(got, _numpy_taus(grid, ROUNDS))
    # tensors already on the device are taken as they are
    again = timing_torch.grid_recurrence_taus(
        *(torch.as_tensor(np.ascontiguousarray(x)) for x in (
            grid.d0, grid.pair_comp, grid.strong, grid.trans,
            grid.lone_comp, grid.num_states)), 700, device="cpu")
    np.testing.assert_array_equal(again, got[:, :700])


def test_paper_reports_and_matrix_equal(paper_grid):
    plans, grid = paper_grid
    got = grid.reports(ROUNDS, backend="torch", device="cpu")
    want = grid.reports(ROUNDS)
    assert got == want
    assert got == [p.report(ROUNDS) for p in plans]
    np.testing.assert_array_equal(
        grid.cycle_time_matrix(900, backend="torch", device="cpu"),
        grid.cycle_time_matrix(900))
    np.testing.assert_array_equal(
        grid.cycle_time_matrix(900, retire=False, backend="torch",
                               device="cpu"),
        grid.cycle_time_matrix(900))


@pytest.mark.parametrize("net_name", ["gaia", "geant", "ebone"])
def test_shared_rows_bit_equal(net_name):
    """Shared ``(E,)`` ``d0``/``pair_comp`` (the scorer's case) over a
    seeded random candidate set, capped and uncapped, against the numpy
    engine fed the same rows broadcast to ``(C, E)``."""
    net, wl = get_network(net_name), WORKLOADS["femnist"]
    overlay = catalog.ring_topology(net, wl).graph
    e = len(overlay.pairs)
    rng = np.random.default_rng(11)
    cands = [tuple(int(x) for x in rng.integers(1, 9, e)) for _ in range(24)]
    comp = wl.compute_ms(net).astype(np.float64)
    pi = np.array([p[0] for p in overlay.pairs])
    pj = np.array([p[1] for p in overlay.pairs])
    d0 = timing.pair_delay_vector(net, wl, pi, pj, overlay.degrees())
    pair_comp = np.maximum(comp[pi], comp[pj])
    for cap in (timing.CAP_STATES, None):
        b = batched.stack_multiplicity_candidates(overlay, comp, cands,
                                                  cap_states=cap)
        got = timing_torch.grid_recurrence_taus(
            d0, pair_comp, b.strong, b.trans, b.lone_comp, b.num_states,
            1500, device="cpu")
        want = timing._grid_recurrence_taus(
            np.broadcast_to(d0, (len(cands), e)),
            np.broadcast_to(pair_comp, (len(cands), e)), b.strong, b.trans,
            b.lone_comp, b.num_states, 1500)
        np.testing.assert_array_equal(got, want)


def test_edges_and_rounds_edge_cases():
    """No rounds, one round, and cells with no edge at all (``E_max`` 0,
    where `torch.amax` would raise and the max of nothing is -inf)."""
    rng = np.random.default_rng(2)
    c, s = 3, 4
    lone = rng.uniform(1.0, 5.0, (c, s))
    ns = np.array([1, 2, 4])
    args = (np.zeros((c, 0)), np.zeros((c, 0)), np.zeros((c, s, 0), bool),
            np.zeros((c, s, 0), np.int8), lone, ns)
    got = timing_torch.grid_recurrence_taus(*args, 9, device="cpu")
    np.testing.assert_array_equal(
        got, np.stack([lone[i, np.arange(9) % ns[i]] for i in range(c)]))
    assert timing_torch.grid_recurrence_taus(
        *args, 0, device="cpu").shape == (c, 0)
    plan = timing.make_timing_plan("multigraph", get_network("gaia"),
                                   WORKLOADS["femnist"])
    grid = timing.build_timing_grid([plan])
    np.testing.assert_array_equal(_taus(grid, 1, "cpu"),
                                  _numpy_taus(grid, 1))
    with pytest.raises(ValueError, match=r"\(C, S, E\)"):
        timing_torch.grid_recurrence_taus(grid.d0, grid.pair_comp,
                                          grid.strong[0], grid.trans,
                                          grid.lone_comp, grid.num_states,
                                          5, device="cpu")


def test_grid_without_recurrence_rows():
    """A grid of cyclic cells only: the torch backend has nothing to step
    and gives the numpy backend's rows."""
    net, wl = get_network("gaia"), WORKLOADS["femnist"]
    plans = [timing.make_timing_plan(t, net, wl)
             for t in ("star", "ring", "mst")]
    grid = timing.build_timing_grid(plans)
    assert grid.rec_rows == ()
    assert grid.reports(300, backend="torch", device="cpu") == \
        grid.reports(300)
    np.testing.assert_array_equal(
        grid.cycle_time_matrix(300, backend="torch", device="cpu"),
        grid.cycle_time_matrix(300))


def test_unknown_backends_raise():
    net, wl = get_network("gaia"), WORKLOADS["femnist"]
    plans = [timing.make_timing_plan("multigraph", net, wl),
             timing.make_timing_plan("star", net, wl)]
    for grid in (timing.build_timing_grid(plans),
                 timing.build_timing_grid(plans[1:])):
        for call in (grid.reports, grid.cycle_time_matrix):
            for name in ("jax", "cuda", "bogus"):
                with pytest.raises(ValueError, match="backend"):
                    call(64, backend=name)
    with pytest.raises(ValueError, match="backend"):
        sweep.run_sweep(dataclasses.replace(
            sweep.SweepConfig(networks=("gaia",), workloads=("femnist",),
                              topologies=("multigraph",), num_rounds=64),
            backend="jax"))


@pytest.mark.cuda
def test_paper_grid_on_the_card(paper_grid):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    plans, grid = paper_grid
    np.testing.assert_array_equal(_taus(grid, ROUNDS, None),
                                  _numpy_taus(grid, ROUNDS))
    assert grid.reports(ROUNDS, backend="torch") == grid.reports(ROUNDS)
