"""Shared set-up of the `run_fl` parity tests (`test_torch_slice*.py`):
start the port from the reference trainer's initial parameters and hold
the two results against each other."""

import dataclasses

import jax
import numpy as np

from repro.fl import FLConfig as RConfig, run_fl as rrun_fl
from repro.models.small import SMALL_MODELS as RMODELS

from repro_torch.fl import FLConfig as PConfig, run_fl as prun_fl
from repro_torch.models import small as psmall


def reference_init(model: str, num_silos: int, seed: int = 0):
    """The reference trainer's initial parameters: `init_flat_state`
    draws from the first of ``num_silos`` split keys."""
    key = jax.random.split(jax.random.PRNGKey(seed), num_silos)[0]
    return jax.device_get(RMODELS[model].init(key))


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def start_port_from(monkeypatch, model: str, params) -> None:
    """Make the port's `model` initialise to ``params`` (numpy tree)."""
    init = psmall.params_from_reference(params)
    monkeypatch.setitem(
        psmall.SMALL_MODELS, model,
        dataclasses.replace(psmall.SMALL_MODELS[model],
                            init=lambda gen: _clone(init)))


def run_both(**kw):
    """(reference result, port result on the CPU) for one config."""
    return rrun_fl(RConfig(**kw)), prun_fl(PConfig(**kw), device="cpu")


def assert_same_run(got, ref, rtol: float, acc_atol: float) -> None:
    """Timing fields exactly equal, losses within ``rtol``, accuracies
    within ``acc_atol`` (one test sample is 1 / test-set size)."""
    assert got.cycle_times_ms == ref.cycle_times_ms
    assert got.mean_cycle_ms == ref.mean_cycle_ms
    assert got.total_time_s == ref.total_time_s
    assert got.eval_rounds == ref.eval_rounds
    assert len(got.round_losses) == len(ref.round_losses)
    np.testing.assert_allclose(got.round_losses, ref.round_losses, rtol=rtol)
    np.testing.assert_allclose(got.eval_accs, ref.eval_accs, rtol=0,
                               atol=acc_atol)
