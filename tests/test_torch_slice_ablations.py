"""`run_fl` of the port against `repro.fl.run_fl` for the multigraph with
an explicit multiplicity vector (Algorithm 1's own, which must also
train exactly as the default run, and another) and with two silos
removed under both strategies (the Table 4 ablation), FEMNIST on gaia.

Tolerances as in `test_torch_slice_topologies.py`: timing fields exactly
equal, losses within 1e-5 relative, accuracies within one of the 512
test samples.
"""

import pytest

jax = pytest.importorskip("jax")

from _torch_fl_parity import (assert_same_run, reference_init,  # noqa: E402
                              run_both, start_port_from)

from repro_torch.core.delay import FEMNIST  # noqa: E402
from repro_torch.core.multigraph import build_multigraph  # noqa: E402
from repro_torch.design.catalog import ring_topology  # noqa: E402
from repro_torch.faults import removed_network  # noqa: E402
from repro_torch.fl import FLConfig, run_fl  # noqa: E402
from repro_torch.networks.registry import get_network  # noqa: E402

KW = dict(rounds=6, eval_every=4, samples_per_silo=16, batch_size=4,
          lr=0.001)


def _check(monkeypatch, num_silos, **change):
    start_port_from(monkeypatch, "femnist_cnn",
                    reference_init("femnist_cnn", num_silos))
    ref, got = run_both(**KW, **change)
    assert_same_run(got, ref, rtol=1e-5, acc_atol=1 / 512)
    return got


def _alg1_vector():
    net = get_network("gaia")
    overlay = ring_topology(net, FEMNIST).graph
    mg = build_multigraph(net, FEMNIST, overlay)
    return tuple(mg.multiplicity[p] for p in overlay.pairs)


@pytest.mark.parametrize("which", ["algorithm1", "other"])
def test_multiplicity_matches_reference(monkeypatch, which):
    mult = _alg1_vector()
    if which == "other":
        mult = tuple(1 + i % 3 for i in range(len(mult)))
    got = _check(monkeypatch, 11, multiplicity=mult)
    if which == "algorithm1":
        # Algorithm 1's own vector trains exactly as the default run
        start_port_from(monkeypatch, "femnist_cnn",
                        reference_init("femnist_cnn", 11))
        default = run_fl(FLConfig(**KW), device="cpu")
        assert got.round_losses == default.round_losses
        assert got.eval_accs == default.eval_accs
        assert got.cycle_times_ms == default.cycle_times_ms


@pytest.mark.parametrize("strategy", ["random", "inefficient"])
def test_remove_silos_matches_reference(monkeypatch, strategy):
    net, _ = removed_network(get_network("gaia"), FEMNIST, k=2,
                             strategy=strategy, seed=0)
    assert net.num_silos == 9
    _check(monkeypatch, net.num_silos, remove_silos=2,
           remove_strategy=strategy)
