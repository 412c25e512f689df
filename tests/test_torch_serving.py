"""The port's serving engine (`repro_torch.serving.ServingEngine`) on the
CPU: the reference engine tests (`tests/test_serving.py`) on reduced
yi-9b, mamba2-370m and zamba2-1.2b, and the port's engine against
`repro.serving.ServingEngine` on the same requests, with the reference's
weights carried across by `params_from_reference` (`jax.random.PRNGKey`
seed 0): tokens equal, logits within 1e-5 relative L2 per step (both
fp32; the readings are about 1e-6, the two packages summing in other
orders). The captured step runs only on the card
(`tests/test_torch_kernel_cuda.py`); on the CPU the engine runs its
step eagerly.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro import configs as rconfigs  # noqa: E402
from repro.models import transformer as rtf  # noqa: E402
from repro.serving import Request as RRequest  # noqa: E402
from repro.serving import ServingEngine as RServingEngine  # noqa: E402

from repro_torch import configs as pconfigs  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from repro_torch.serving.engine import _cache_leaves  # noqa: E402

ARCHS = ["yi_9b", "mamba2_370m", "zamba2_1p2b"]
LOGITS_REL_TOL = 1e-5


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(port cfg, port params, reference cfg, reference params)."""
    rcfg = rconfigs.reduce(rconfigs.get_config(request.param))
    rparams = rtf.init_params(rcfg, jax.random.PRNGKey(0))
    cfg = pconfigs.reduce(pconfigs.get_config(request.param))
    return cfg, tf.params_from_reference(jax.device_get(rparams)), rcfg, \
        rparams


def _engine(cfg, params, **kw):
    return ServingEngine(cfg, params, device="cpu", **kw)


def _offline_greedy(cfg, params, prompt, max_new, max_seq=64):
    """Single-request greedy decode via the scalar-position path."""
    state = tf.init_decode_state(cfg, 1, max_seq=max_seq,
                                 dtype=torch.float32, device="cpu")
    out = []
    for t in prompt:
        logits, state = tf.decode_step(params, cfg, torch.tensor([[t]]),
                                       state)
    tok = int(torch.argmax(logits[0, -1]))
    out.append(tok)
    while len(out) < max_new:
        logits, state = tf.decode_step(params, cfg, torch.tensor([[tok]]),
                                       state)
        tok = int(torch.argmax(logits[0, -1]))
        out.append(tok)
    return out


def test_engine_matches_offline_single(model):
    cfg, params = model[:2]
    prompt = [5, 9, 2, 7]
    ref = _offline_greedy(cfg, params, prompt, 6)
    eng = _engine(cfg, params, max_slots=2, max_seq=64)
    eng.submit(Request(prompt=list(prompt), max_new_tokens=6))
    done = eng.run()
    assert len(done) == 1
    assert done[0].output == ref


def test_engine_batching_independence(model):
    """Same request, three traffic patterns, identical output."""
    cfg, params = model[:2]
    prompt = [3, 1, 4, 1, 5]
    ref = _offline_greedy(cfg, params, prompt, 5)

    # pattern 1: alone
    e1 = _engine(cfg, params, max_slots=3, max_seq=64)
    r1 = Request(prompt=list(prompt), max_new_tokens=5)
    e1.submit(r1)
    e1.run()

    # pattern 2: submitted alongside two other requests
    e2 = _engine(cfg, params, max_slots=3, max_seq=64)
    e2.submit(Request(prompt=[9, 9], max_new_tokens=8))
    r2 = Request(prompt=list(prompt), max_new_tokens=5)
    e2.submit(r2)
    e2.submit(Request(prompt=[1, 2, 3, 4, 5, 6, 7], max_new_tokens=3))
    e2.run()

    # pattern 3: admitted LATE into a warm engine (slot reuse)
    e3 = _engine(cfg, params, max_slots=2, max_seq=64)
    e3.submit(Request(prompt=[8, 8, 8], max_new_tokens=4))
    e3.submit(Request(prompt=[2, 2], max_new_tokens=4))
    for _ in range(5):
        e3.step()
    r3 = Request(prompt=list(prompt), max_new_tokens=5)
    e3.submit(r3)
    e3.run()

    assert r1.output == ref
    assert r2.output == ref
    assert r3.output == ref


def test_engine_queue_overflow_and_completion(model):
    cfg, params = model[:2]
    eng = _engine(cfg, params, max_slots=2, max_seq=64)
    reqs = [Request(prompt=[i + 1, i + 2], max_new_tokens=3)
            for i in range(5)]
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    assert len(done) == 5
    assert all(len(r.output) == 3 for r in reqs)
    assert eng.utilization() == 0.0


def test_engine_eos_stops_early(model):
    cfg, params = model[:2]
    # find the first greedy token, then use it as EOS
    first = _offline_greedy(cfg, params, [5, 6], 1)[0]
    eng = _engine(cfg, params, max_slots=1, max_seq=64)
    r = Request(prompt=[5, 6], max_new_tokens=10, eos_id=first)
    eng.submit(r)
    eng.run()
    assert r.done and len(r.output) == 1 and r.output[0] == first


def test_vector_positions_match_scalar(model):
    """decode_step with a (B,) position vector of equal entries must
    equal the scalar-position path."""
    cfg, params = model[:2]
    toks = torch.tensor([[3], [7]])
    s_a = tf.init_decode_state(cfg, 2, max_seq=32, dtype=torch.float32,
                               device="cpu")
    s_b = tf.init_decode_state(cfg, 2, max_seq=32, dtype=torch.float32,
                               device="cpu")
    s_b.position = torch.zeros((2,), dtype=torch.int64)
    for _ in range(3):
        la, s_a = tf.decode_step(params, cfg, toks, s_a)
        lb, s_b = tf.decode_step(params, cfg, toks, s_b)
        np.testing.assert_allclose(la.numpy(), lb.numpy(), rtol=1e-6,
                                   atol=1e-6)
    assert tuple(s_b.position.shape) == (2,)


#: more requests than slots, prompts of several lengths, an EOS that can
#: fire: (prompt, max_new_tokens, eos_id)
TRAFFIC = [([3, 1, 4, 1, 5], 6, None), ([9, 9], 8, None),
           ([1, 2, 3, 4, 5, 6, 7], 3, None), ([8, 8, 8], 4, 17),
           ([2, 2], 5, None), ([6, 5, 4, 3, 2, 1, 0, 11, 12], 7, None)]


def _recording(logits_out, to_np, argmax):
    def sample(logits):
        logits_out.append(to_np(logits))
        return argmax(logits)
    return sample


def test_engine_matches_reference_engine(model):
    """The same requests through both packages' engines (3 slots, so
    later requests take freed slots): every request's tokens equal, every
    step's logits within LOGITS_REL_TOL relative L2."""
    cfg, params, rcfg, rparams = model
    rlog, plog = [], []
    reng = RServingEngine(rcfg, rparams, max_slots=3, max_seq=64,
                          sample=_recording(rlog, np.asarray,
                                            lambda x: jnp.argmax(x, -1)))
    peng = _engine(cfg, params, max_slots=3, max_seq=64,
                   sample=_recording(plog, lambda x: x.numpy().copy(),
                                     lambda x: torch.argmax(x, -1)))
    rreqs = [RRequest(prompt=list(p), max_new_tokens=n, eos_id=e)
             for p, n, e in TRAFFIC]
    preqs = [Request(prompt=list(p), max_new_tokens=n, eos_id=e)
             for p, n, e in TRAFFIC]
    for a, b in zip(rreqs, preqs):
        reng.submit(a)
        peng.submit(b)
    reng.run()
    peng.run()
    assert [r.output for r in preqs] == [r.output for r in rreqs]
    assert [r.rid for r in peng.completed] == [r.rid for r in reng.completed]
    assert len(plog) == len(rlog) == peng.steps
    for k, (got, want) in enumerate(zip(plog, rlog)):
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= LOGITS_REL_TOL, (k, rel)


def test_reset_zeroes_caches_in_place(model):
    """reset() keeps every cache tensor (a captured step reads them by
    address), zeroes it, and serves the same tokens again."""
    cfg, params = model[:2]
    eng = _engine(cfg, params, max_slots=2, max_seq=32)
    leaves = _cache_leaves(eng.caches)
    ptrs = [a.data_ptr() for a in leaves]

    def serve():
        reqs = [Request(prompt=list(p), max_new_tokens=n)
                for p, n, _ in TRAFFIC[:3]]
        for r in reqs:
            eng.submit(r)
        eng.run()
        return [r.output for r in reqs]

    first = serve()
    assert any(bool(a.any()) for a in leaves)
    eng.reset()
    assert [a.data_ptr() for a in _cache_leaves(eng.caches)] == ptrs
    assert not any(bool(a.any()) for a in leaves)
    assert not eng.positions.any() and not eng.queue and not eng.completed
    assert serve() == first
    assert eng.captures == 0  # the CPU runs its step eagerly


def test_submit_refuses_what_the_reference_asserts(model):
    cfg, params = model[:2]
    eng = _engine(cfg, params, max_slots=1, max_seq=8)
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit(Request(prompt=[1, 2, 3], max_new_tokens=6))
    with pytest.raises(ValueError, match="empty"):
        eng.submit(Request(prompt=[], max_new_tokens=2))


def test_engine_without_device_needs_a_card(model):
    cfg, params = model[:2]
    if torch.cuda.is_available():
        assert ServingEngine(cfg, params).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServingEngine(cfg, params)


def test_decode_attention_takes_lengths_on_the_device_alone():
    """`lengths=None` with `lengths_dev` (the captured step's call): the
    same result as with host lengths; neither raises."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               for s in ((3, 4, 32), (3, 16, 2, 32), (3, 16, 2, 32)))
    lengths = torch.tensor([1, 7, 16], dtype=torch.int32)
    want = dec_ops.decode_attention(q, k, v, lengths)
    got = dec_ops.decode_attention(q, k, v, None, lengths_dev=lengths)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="lengths_dev"):
        dec_ops.decode_attention(q, k, v, None)


@pytest.mark.parametrize("device_positions", [False, True])
@pytest.mark.parametrize("arch", ["yi_9b", "zamba2_1p2b"])
def test_decode_step_checks_positions_it_reads_on_the_host(arch,
                                                          device_positions):
    """`decode_step` reads positions on the host and its attention op
    (impl="kernel") refuses a negative one (past max_seq the ring buffer wraps); on the CPU the device is the host, so
    `device_positions=True` is checked too. On the card that flag leaves
    the check to the caller (`ServingEngine`) and needs positions on the
    model's device."""
    cfg = pconfigs.reduce(pconfigs.get_config(arch))
    params = tf.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    state = tf.init_decode_state(cfg, 2, 16, dtype=torch.float32,
                                 device="cpu")
    tokens = torch.tensor([[3], [5]])
    for bad in ([0, -1], [-3, 2]):
        state.position = torch.tensor(bad)
        with pytest.raises(ValueError, match="lengths must lie in"):
            tf.decode_step(params, cfg, tokens, state, impl="kernel",
                           device_positions=device_positions)
    state.position = torch.tensor([0, 1], device="meta")
    if device_positions:
        with pytest.raises(ValueError, match="device_positions needs"):
            tf.decode_step(params, cfg, tokens, state, impl="kernel",
                           device_positions=True)
