"""The plain reference against the program on the CPU: the plan and the
simulated clock exactly, the training within rounding."""

import json

import numpy as np
import pytest
import torch

from bench import check, harness
from bench.reference import fl as reffl
from bench.reference import overlay, topology_multigraph

from _small import small_cell


@pytest.mark.parametrize("config", ["femnist_cnn", "inat_resnet"])
@pytest.mark.parametrize("network", ["gaia", "ebone"])
def test_plan_and_clock_equal_the_programs(config, network):
    from repro_torch.core.delay import WORKLOADS
    from repro_torch.fl import dpasgd
    from repro_torch.networks.registry import get_network

    cfg = json.loads((harness.BENCH / "configs" /
                      f"{config}.json").read_text())
    wl = cfg["workload"]
    plan = topology_multigraph.plan(overlay.load_network(network), wl,
                                    {"t": 5})
    want, tplan = dpasgd.make_round_schedule(
        "multigraph", get_network(network), WORKLOADS[wl["name"]], t=5,
        rounds=200)
    s = plan.num_states
    assert s == want.num_rounds_cycle
    assert np.array_equal(plan.src, want.src)
    assert np.array_equal(plan.dst, want.dst)
    assert np.array_equal(plan.strong, want.strong)
    assert np.array_equal(np.tile(plan.coeffs, (s, 1)), want.coeffs)
    assert np.array_equal(np.tile(plan.diag, (s, 1)), want.diag)
    taus = topology_multigraph.cycle_times(plan, 200)
    assert np.array_equal(taus, tplan.cycle_times(200))
    rep = tplan.report(200)
    assert float(taus.mean()) == rep.mean_cycle_ms
    assert float(taus.sum()) / 1000.0 == rep.total_time_s


@pytest.mark.parametrize("config,rounds,batch", [
    ("femnist_cnn", 4, 8), ("inat_resnet", 1, 2)])
def test_reference_follows_run_fl(config, rounds, batch):
    from repro_torch.fl import FLConfig, run_fl

    cell = small_cell(config, rounds=rounds, batch=batch)
    seed = 2 ** 31 + 11
    res = run_fl(FLConfig(**harness.fl_kwargs(cell, seed)), device="cpu")
    ref = reffl.run(cell.cfg, cell.traffic, seed, device="cpu",
                    check_rounds=rounds)
    numbers = check.compare(res, ref, rounds)
    assert numbers["sim_gap_ms"] == 0.0
    assert numbers["loss_rel_gap"] < 1e-5
    assert res.eval_rounds == ref.eval_rounds
    assert np.abs(np.subtract(res.eval_accs, ref.eval_accs)).max() <= 1 / 512


def test_reference_initialisers_draw_the_programs_parameters():
    from repro_torch.models.small import SMALL_MODELS

    for name in ("femnist_cnn", "inat_resnet"):
        cfg = json.loads((harness.BENCH / "configs" /
                          f"{name}.json").read_text())
        mine = reffl.load_model(name).init(cfg, torch.Generator()
                                           .manual_seed(5))
        theirs = SMALL_MODELS[name].init(torch.Generator().manual_seed(5))
        a = dict(reffl._leaves(mine))
        b = dict(reffl._leaves(theirs))
        assert list(a) == list(b)
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_reference_data_equals_the_programs():
    from repro_torch.data.synthetic import make_federated_dataset
    from bench.reference import dataset_image

    for name in ("femnist_cnn", "inat_resnet"):
        cfg = json.loads((harness.BENCH / "configs" /
                          f"{name}.json").read_text())
        mine = dataset_image.make_dataset(cfg["data"], 11, 16, 0.5, 9)
        theirs = make_federated_dataset(cfg["dataset"], 11,
                                        samples_per_silo=16, alpha=0.5,
                                        seed=9)
        assert all(np.array_equal(a, b)
                   for a, b in zip(mine.silo_x, theirs.silo_x))
        assert all(np.array_equal(a, b)
                   for a, b in zip(mine.silo_y, theirs.silo_y))
        assert np.array_equal(mine.test_x, theirs.test_x)
