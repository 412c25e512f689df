"""The port's serving examples (`examples_torch/serve_decode.py`,
`continuous_batching.py`) on the CPU against the reference's, from the
reference's weights (`jax.random.PRNGKey(0)`) carried across by
`params_from_reference`: `serve_decode`'s 24 greedy tokens of every
sequence equal to the reference's `decode_step` loop, and its printed
lines to the reference's format; `continuous_batching`'s stdout equal to
the reference script's line for line, but for the line with the wall
time (its request outputs and engine steps).
"""

import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro import configs as rconfigs  # noqa: E402
from repro.models import transformer as rtf  # noqa: E402

from repro_torch.models import transformer as tf  # noqa: E402

from _torch_examples import load_port, run_reference  # noqa: E402
from _torch_fl_parity import one_thread  # noqa: E402,F401


def _reference_params(arch: str):
    rcfg = rconfigs.reduce(rconfigs.get_config(arch))
    return rcfg, rtf.init_params(rcfg, jax.random.PRNGKey(0))


def test_serve_decode_tokens_equal_reference(capsys):
    batch, steps = 4, 24
    rcfg, rparams = _reference_params("gemma3-27b")
    res = load_port("serve_decode").main(
        ["--device", "cpu"],
        params=tf.params_from_reference(jax.device_get(rparams)))
    lines = capsys.readouterr().out.splitlines()
    # the reference example's loop (examples/serve_decode.py)
    state = rtf.init_decode_state(rcfg, batch, max_seq=64, dtype=jnp.float32)
    step = jax.jit(lambda t, s: rtf.decode_step(rparams, rcfg, t, s))
    tok = jnp.zeros((batch, 1), jnp.int32)
    outs = []
    for _ in range(steps):
        logits, state = step(tok, state)
        tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
        outs.append(tok[:, 0])
    want = jnp.stack(outs, axis=1).tolist()
    assert res["tokens"].tolist() == want
    assert tuple(res["logits"].shape) == (steps, batch, rcfg.vocab_size)
    assert lines[0] == f"arch={rcfg.name} family={rcfg.family}"
    assert lines[1].startswith(f"decoded {steps} steps x batch {batch} in ")
    assert lines[1].endswith(" tok/s on CPU)")
    assert lines[2:] == [f"  seq[{b}]: {want[b][:16]}" for b in range(2)]


def test_continuous_batching_equals_reference(capsys, monkeypatch):
    rcfg, rparams = _reference_params("yi-9b")
    res = load_port("continuous_batching").main(
        ["--device", "cpu"],
        params=tf.params_from_reference(jax.device_get(rparams)))
    port = capsys.readouterr().out.splitlines()
    run_reference(monkeypatch, "continuous_batching")
    ref = capsys.readouterr().out.splitlines()
    timed = [i for i, ln in enumerate(ref) if " engine steps (" in ln]
    assert len(timed) == 1 and len(port) == len(ref)
    i = timed[0]
    assert port[:i] == ref[:i] and port[i + 1:] == ref[i + 1:]
    assert port[i].split(" (")[0] == ref[i].split(" (")[0]
    assert port[i].endswith("s on CPU)")
    assert res["steps"] == res["engine"].steps
    assert len(res["outputs"]) == 5 and res["engine"].captures == 0
