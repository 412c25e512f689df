"""`run_fl` of the port against `repro.fl.run_fl` for the Sent140 LSTM
and the iNaturalist ResNet, on gaia over the multigraph.

Both sides start from the reference's initial parameters and draw the
same numpy batches; lr is 0.001 as in `test_torch_slice.py`. The timing
fields must be exactly equal and the losses agree within 1e-5 relative
(measured: 9e-8 for the LSTM and 2.2e-6 for the ResNet, whose batch
norms over two samples amplify the fp32 reordering). To keep the
ResNet's evaluation short on the CPU both trainers are handed the same
dataset with its test set cut to its first 64 samples; accuracies agree
within one of them.
"""

import pytest

jax = pytest.importorskip("jax")

import repro.fl.trainer as rtrainer  # noqa: E402
from _torch_fl_parity import (assert_same_run, reference_init,  # noqa: E402
                              run_both, start_port_from)

import repro_torch.fl.trainer as ptrainer  # noqa: E402

TEST_SAMPLES = 64


def _short_test_set(monkeypatch):
    for mod in (rtrainer, ptrainer):
        make = mod.make_federated_dataset

        def cut(*a, _make=make, **kw):
            data = _make(*a, **kw)
            data.test_x = data.test_x[:TEST_SAMPLES]
            data.test_y = data.test_y[:TEST_SAMPLES]
            return data
        monkeypatch.setattr(mod, "make_federated_dataset", cut)


@pytest.mark.parametrize("dataset,model,rounds", [
    ("sent140", "sent140_lstm", 4), ("inat", "inat_resnet", 2)])
def test_model_run_fl_matches_reference(monkeypatch, dataset, model, rounds):
    _short_test_set(monkeypatch)
    start_port_from(monkeypatch, model, reference_init(model, 11))
    ref, got = run_both(dataset=dataset, rounds=rounds, eval_every=rounds,
                        samples_per_silo=8, batch_size=2, lr=0.001)
    assert len(got.round_losses) == rounds
    assert_same_run(got, ref, rtol=1e-5, acc_atol=1 / TEST_SAMPLES)
