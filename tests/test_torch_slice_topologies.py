"""`run_fl` of the port against `repro.fl.run_fl` for FEMNIST under every
Table-1 topology other than the multigraph (star, mst, dmbst, ring,
matcha, matcha_plus) on gaia, and the multigraph on geant, whose overlay
needs the blossom matching. The ablations are in
`test_torch_slice_ablations.py`.

Both sides start from the reference's initial parameters and draw the
same numpy batches. The timing fields must be exactly equal; the losses
agree within 1e-5 relative (the per-silo gradients differ by a few fp32
ulps, see `test_torch_slice.py`, which also says why lr is 0.001), and
accuracies within one of the 512 test samples.
"""

import pytest

jax = pytest.importorskip("jax")

from _torch_fl_parity import (assert_same_run, reference_init,  # noqa: E402
                              run_both, start_port_from)

from repro_torch.networks.registry import get_network  # noqa: E402

KW = dict(rounds=6, eval_every=4, samples_per_silo=16, batch_size=4,
          lr=0.001)


def _check(monkeypatch, num_silos, **change):
    start_port_from(monkeypatch, "femnist_cnn",
                    reference_init("femnist_cnn", num_silos))
    ref, got = run_both(**KW, **change)
    assert_same_run(got, ref, rtol=1e-5, acc_atol=1 / 512)
    return got


@pytest.mark.parametrize("topology", ["star", "mst", "dmbst", "ring",
                                      "matcha", "matcha_plus"])
def test_topology_matches_reference(monkeypatch, topology):
    got = _check(monkeypatch, 11, topology=topology)
    assert len(got.round_losses) == KW["rounds"]


def test_multigraph_on_geant_matches_reference(monkeypatch):
    _check(monkeypatch, get_network("geant").num_silos, network="geant")
