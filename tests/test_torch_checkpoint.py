"""The port's checkpoints against the reference's: its msgpack codec
against the `msgpack` package (hypothesis over the trees the encoder
emits, and every length header at its edges), pytree and FL checkpoint
bytes equal to the reference's for the same tree, files of either
package restoring bit for bit in the other, retention, and `run_fl`'s
checkpoints against the reference's.
"""

import math

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
msgpack = pytest.importorskip("msgpack")
hypothesis = pytest.importorskip("hypothesis")
ml_dtypes = pytest.importorskip("ml_dtypes")
from hypothesis import given, settings, strategies as st  # noqa: E402

from _torch_fl_parity import reference_init, start_port_from  # noqa: E402
from repro.checkpoint import ckpt as rckpt  # noqa: E402
from repro.fl import FLConfig as RConfig, run_fl as rrun_fl  # noqa: E402

from repro_torch.checkpoint import _msgpack, ckpt as pckpt  # noqa: E402
from repro_torch.fl import FLConfig as PConfig, run_fl as prun_fl  # noqa: E402
from repro_torch.fl import flat as pflat  # noqa: E402
from repro_torch.models import small as psmall  # noqa: E402

_scalars = (st.none() | st.booleans()
            | st.integers(-2 ** 63, 2 ** 64 - 1)
            | st.floats(allow_nan=True, allow_infinity=True)
            | st.text(max_size=40) | st.binary(max_size=300))
_keys = st.text(max_size=10) | st.binary(max_size=10) | st.integers(-5, 300)
_trees = st.recursive(
    _scalars,
    lambda kids: (st.lists(kids, max_size=20)
                  | st.tuples(kids, kids)
                  | st.dictionaries(_keys, kids, max_size=20)),
    max_leaves=60)


@settings(max_examples=150, deadline=None)
@given(_trees)
def test_packb_matches_msgpack(tree):
    assert _msgpack.packb(tree) == msgpack.packb(tree, use_bin_type=True)


@settings(max_examples=150, deadline=None)
@given(_trees, st.booleans())
def test_unpackb_matches_msgpack(tree, single_float):
    """Decoding what msgpack packs gives what ``unpackb(raw=True,
    strict_map_key=False)`` gives; compared by re-encoding, which holds
    NaN to its bits. float32 (single_float) decodes too."""
    raw = msgpack.packb(tree, use_bin_type=True,
                        use_single_float=single_float)
    got = _msgpack.unpackb(raw)
    want = msgpack.unpackb(raw, raw=True, strict_map_key=False)
    assert msgpack.packb(got, use_bin_type=True) == \
        msgpack.packb(want, use_bin_type=True)


@pytest.mark.parametrize("n", [0, 15, 16, 31, 32, 255, 256, 65535, 65536])
def test_length_headers_match_msgpack(n):
    """fix / 8 / 16 / 32-bit lengths of str, bin, array and map at their
    edges, both ways."""
    for obj in ("a" * n, b"b" * n, [1] * n, {i: None for i in range(n)}):
        raw = msgpack.packb(obj, use_bin_type=True)
        assert _msgpack.packb(obj) == raw
        assert _msgpack.unpackb(raw) == msgpack.unpackb(
            raw, raw=True, strict_map_key=False)


@pytest.mark.parametrize("value", [
    0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1,
    -2 ** 63, True, False, None, 0.0, -0.0, 1.5, math.inf])
def test_scalars_match_msgpack(value):
    raw = msgpack.packb(value, use_bin_type=True)
    assert _msgpack.packb(value) == raw
    assert _msgpack.unpackb(raw) == value


def test_codec_refuses_what_msgpack_refuses():
    for bad in (2 ** 64, -2 ** 63 - 1):
        with pytest.raises(OverflowError):
            msgpack.packb(bad)
        with pytest.raises(OverflowError):
            _msgpack.packb(bad)
    with pytest.raises(TypeError):
        _msgpack.packb({1, 2})
    raw = _msgpack.packb({"a": [1, 2, b"xyz"]})
    with pytest.raises(ValueError, match="end of data"):
        _msgpack.unpackb(raw[:-1])
    with pytest.raises(ValueError, match="extra data"):
        _msgpack.unpackb(raw + b"\x00")
    with pytest.raises(ValueError, match="unsupported"):
        _msgpack.unpackb(b"\xc1")


def _rows(n=11, t=4099, seed=0):
    return np.random.default_rng(seed).standard_normal((n, t)).astype(
        np.float32)


META = dict(network="gaia", dataset="femnist", topology="multigraph", t=5,
            seed=0, num_silos=11, multiplicity=(1, 2, 3), lr=0.05,
            momentum=0.9, alpha=0.5, sim_time_ms=1234.5678,
            loss_tail=[4.5, 4.25], eval_accs=[0.125], extra={"z": None,
                                                             "a": 3})


@pytest.mark.parametrize("meta", [META, dict(META, round=7), {}])
def test_fl_checkpoint_bytes_match_reference(tmp_path, meta):
    w = _rows()
    rckpt.save_fl_checkpoint(rckpt.CheckpointManager(tmp_path / "r"), 15, w,
                             **meta)
    pckpt.save_fl_checkpoint(pckpt.CheckpointManager(tmp_path / "p"), 15,
                             torch.from_numpy(w), **meta)
    want = (tmp_path / "r" / "step_15.msgpack").read_bytes()
    assert (tmp_path / "p" / "step_15.msgpack").read_bytes() == want
    pckpt.save_fl_checkpoint(pckpt.CheckpointManager(tmp_path / "q"), 15, w,
                             **meta)  # from numpy rows too
    assert (tmp_path / "q" / "step_15.msgpack").read_bytes() == want


def _mixed_tree(bf16):
    """A pytree of every kind of leaf, keys in no sorted order."""
    return {"z": (1, "s", None, 2.5, True, [np.int64(3)]),
            "b": bf16, "a": np.float64(3.0), "m": {"y": -7, "x": "text"},
            "i": np.arange(6, dtype=np.int32).reshape(2, 3),
            "h": np.zeros((0, 4), np.float16)}


def test_pytree_bytes_and_bf16_match_reference(tmp_path):
    """A bf16 tensor is written as the reference writes its ml_dtypes
    bf16 array (uint16 bits under "bfloat16"), and each package restores
    the other's file."""
    x = torch.randn(3, 5, generator=torch.Generator().manual_seed(0))
    x = x.to(torch.bfloat16)
    xn = x.view(torch.int16).numpy().view(np.uint16).view(ml_dtypes.bfloat16)
    rckpt.save_pytree(tmp_path / "r.msgpack", _mixed_tree(xn))
    pckpt.save_pytree(tmp_path / "p.msgpack", _mixed_tree(x))
    assert (tmp_path / "p.msgpack").read_bytes() == \
        (tmp_path / "r.msgpack").read_bytes()
    got = pckpt.restore_pytree(tmp_path / "r.msgpack")
    assert list(got) == ["a", "b", "h", "i", "m", "z"]
    assert got["b"].dtype == torch.bfloat16 and torch.equal(got["b"], x)
    assert got["z"][:5] == (1, "s", None, 2.5, True)
    assert got["m"] == {"x": "text", "y": -7}
    np.testing.assert_array_equal(got["i"], np.arange(6).reshape(2, 3))
    assert got["h"].dtype == np.float16 and got["h"].shape == (0, 4)
    back = rckpt.restore_pytree(tmp_path / "p.msgpack")
    assert back["b"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(back["b"].view(np.uint16),
                                  xn.view(np.uint16))
    with pytest.raises(TypeError, match="sort"):
        pckpt.save_pytree(tmp_path / "bad.msgpack", {1: 1, "a": 2})


def test_fl_checkpoints_cross_restore(tmp_path):
    """A file of either package restores in the other, rows bit for bit,
    meta equal."""
    w = _rows(seed=1)
    rckpt.save_fl_checkpoint(rckpt.CheckpointManager(tmp_path / "r"), 3, w,
                             **META)
    pckpt.save_fl_checkpoint(pckpt.CheckpointManager(tmp_path / "p"), 3,
                             torch.from_numpy(w), **META)
    for load, src in ((pckpt.load_fl_checkpoint, "r"),
                      (rckpt.load_fl_checkpoint, "p"),
                      (pckpt.load_fl_checkpoint, "p")):
        got = load(tmp_path / src)
        assert got.step == 3 and got.num_silos == 11
        assert got.w.dtype == np.float32
        np.testing.assert_array_equal(got.w, w)
        assert got.meta == rckpt.load_fl_checkpoint(tmp_path / "r").meta
    meta = pckpt.load_fl_checkpoint(tmp_path / "r").meta
    assert meta["multiplicity"] == [1, 2, 3] and meta["round"] == 3


def test_retention_steps_and_errors(tmp_path):
    """keep, steps(), latest_step and restore(None) as the reference's,
    and the same refusals."""
    w = _rows(n=2, t=8)
    for pkg, d in ((pckpt, tmp_path / "p"), (rckpt, tmp_path / "r")):
        mgr = pkg.CheckpointManager(d, keep=2)
        assert mgr.steps() == [] and pkg.latest_step(d) is None
        with pytest.raises(FileNotFoundError):
            mgr.restore()
        for step in (1, 4, 2, 9):
            pkg.save_fl_checkpoint(mgr, step, w, note=step)
        assert mgr.steps() == [4, 9] and pkg.latest_step(d) == 9
        assert sorted(p.name for p in d.iterdir()) == \
            ["step_4.msgpack", "step_9.msgpack"]
        step, tree = mgr.restore()
        assert step == 9 and tree["meta"]["note"] == 9
        assert pkg.load_fl_checkpoint(mgr, 4).meta["round"] == 4
        mgr.save(12, {"kind": "other"})
        with pytest.raises(ValueError, match="not an FL"):
            pkg.load_fl_checkpoint(d)
        with pytest.raises(ValueError, match=r"\(N, T\)"):
            pkg.save_fl_checkpoint(mgr, 13, w[0])
    for name in ("step_9.msgpack", "step_12.msgpack"):
        assert (tmp_path / "p" / name).read_bytes() == \
            (tmp_path / "r" / name).read_bytes()


def test_run_fl_checkpoints_match_reference(monkeypatch, tmp_path):
    """`run_fl(ckpt_dir=, ckpt_every=2)` over 8 rounds with evals every
    4: the same steps (2, 4, 6, 8), the same meta keys, the timing meta exactly
    equal, the rows and the loss tail within the slice's limits; the
    last step's rows, averaged and evaluated, give the last accuracy."""
    start_port_from(monkeypatch, "femnist_cnn",
                    reference_init("femnist_cnn", 11))
    kw = dict(rounds=8, eval_every=4, samples_per_silo=16, batch_size=4,
              lr=0.001, ckpt_every=2)
    ref = rrun_fl(RConfig(**kw, ckpt_dir=str(tmp_path / "r")))
    got = prun_fl(PConfig(**kw, ckpt_dir=str(tmp_path / "p")), device="cpu")
    pm = pckpt.CheckpointManager(tmp_path / "p")
    assert pm.steps() == rckpt.CheckpointManager(tmp_path / "r").steps() \
        == [2, 4, 6, 8]
    cum = np.cumsum(got.cycle_times_ms)
    for step in (2, 4, 6, 8):
        p = pckpt.load_fl_checkpoint(tmp_path / "p", step)
        r = rckpt.load_fl_checkpoint(tmp_path / "r", step)
        assert list(p.meta) == list(r.meta)
        inexact = ("loss_tail", "eval_accs")
        assert {k: v for k, v in p.meta.items() if k not in inexact} == \
            {k: v for k, v in r.meta.items() if k not in inexact}
        assert p.meta["sim_time_ms"] == cum[step - 1]
        np.testing.assert_allclose(p.meta["loss_tail"], r.meta["loss_tail"],
                                   rtol=1e-5)
        np.testing.assert_allclose(p.meta["eval_accs"], r.meta["eval_accs"],
                                   rtol=0, atol=1 / 512)
        np.testing.assert_allclose(p.w, r.w, rtol=0, atol=1e-4)
    last = pckpt.load_fl_checkpoint(pm)
    spec = psmall.SMALL_MODELS["femnist_cnn"]
    rt_spec = pflat.make_flat_spec(spec.init(torch.Generator()))
    from repro_torch.data.synthetic import make_federated_dataset
    data = make_federated_dataset("femnist", 11, samples_per_silo=16)
    batch = {"x": torch.as_tensor(data.test_x),
             "y": torch.as_tensor(data.test_y, dtype=torch.long)}
    with torch.no_grad():
        acc = spec.accuracy(pflat.unravel(
            rt_spec, torch.from_numpy(last.w.copy()).mean(dim=0)), batch)
    assert float(acc) == got.eval_accs[-1]
