"""Msgpack pytree checkpoints and the FL checkpoint format (counterpart
of `repro.checkpoint.ckpt`), written by the package's own msgpack codec
(`checkpoint/_msgpack.py`).

Arrays are serialized as (dtype name, shape, raw bytes); the tree is
nested msgpack maps. Dict keys are written in sorted order at every
level, as the reference's encoder sees them after `jax.tree.map`, so
both packages write the same bytes for the same tree and each restores
the other's files bit for bit. Writes are atomic (tmp + rename) into
step-numbered files, with a small manager that keeps the newest few.

Leaves may be numpy arrays or torch tensors on any device: a tensor is
copied to the host once. A bf16 tensor is written as its uint16 bits
under the dtype name ``"bfloat16"`` (the name the reference writes) and
restores as a ``torch.bfloat16`` CPU tensor; every other dtype restores
as a read-only numpy array.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import re

import numpy as np
import torch

from repro_torch.checkpoint._msgpack import pack_parts, unpackb

_ARRAY_KEY = b"__nd__"
_BF16 = "bfloat16"


def _pack_leaf(x):
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.dtype == torch.bfloat16:
            arr, name = t.view(torch.int16).cpu().numpy(), _BF16
        else:
            arr = t.cpu().numpy()
            name = arr.dtype.name
    else:
        arr = np.asarray(x)
        name = arr.dtype.name
    # the leaf's bytes in C order, as a view: the writer copies them once,
    # into the file
    data = memoryview(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))
    return {_ARRAY_KEY: True, b"dtype": name, b"shape": list(arr.shape),
            b"data": data}


def _is_packed(obj) -> bool:
    return isinstance(obj, dict) and obj.get(_ARRAY_KEY) is True


def _unpack_leaf(obj):
    name = obj[b"dtype"]
    if isinstance(name, bytes):
        name = name.decode()
    shape = obj[b"shape"]
    if name == _BF16:
        bits = np.frombuffer(obj[b"data"], dtype=np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).reshape(shape)
    try:
        dtype = np.dtype(name)
    except TypeError as exc:
        raise TypeError(f"checkpoint leaf of dtype {name!r} has no numpy "
                        "type") from exc
    return np.frombuffer(obj[b"data"], dtype=dtype).reshape(shape)


def _host_tree(tree):
    """``tree`` as the reference's encoder receives it from `jax.tree.map`:
    dict keys sorted at every level (keys that do not sort raise), lists
    and tuples kept, numpy scalars as 0-d arrays. Tensors stay as they
    are until `_pack_leaf` copies them."""
    if isinstance(tree, dict):
        try:
            keys = sorted(tree)
        except TypeError as exc:
            raise TypeError("checkpoint dict keys must sort together, got "
                            f"{list(tree)!r}") from exc
        return {k: _host_tree(tree[k]) for k in keys}
    if isinstance(tree, (list, tuple)):
        items = [_host_tree(v) for v in tree]
        return items if isinstance(tree, list) else tuple(items)
    if not isinstance(tree, torch.Tensor) and hasattr(tree, "dtype"):
        return np.asarray(tree)
    return tree


def _encode(tree):
    if isinstance(tree, dict):
        return {k: _encode(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {b"__list__": [_encode(v) for v in tree],
                b"__tuple__": isinstance(tree, tuple)}
    if tree is None:
        return {b"__none__": True}
    if isinstance(tree, (int, float, str, bool)):
        return {b"__py__": tree}
    return _pack_leaf(tree)


def _decode(obj):
    if isinstance(obj, dict):
        if _is_packed(obj):
            return _unpack_leaf(obj)
        if b"__none__" in obj:
            return None
        if b"__py__" in obj:
            v = obj[b"__py__"]
            # str comes back as bytes from the raw reader
            return v.decode() if isinstance(v, bytes) else v
        if b"__list__" in obj:
            items = [_decode(v) for v in obj[b"__list__"]]
            return tuple(items) if obj.get(b"__tuple__") else items
        return {(k.decode() if isinstance(k, bytes) else k): _decode(v)
                for k, v in obj.items()}
    return obj


def save_pytree(path: str | os.PathLike, tree) -> None:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    parts = pack_parts(_encode(_host_tree(tree)))
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        f.writelines(parts)
    tmp.rename(path)


def restore_pytree(path: str | os.PathLike):
    return _decode(unpackb(pathlib.Path(path).read_bytes()))


_STEP_RE = re.compile(r"^step_(\d+)\.msgpack$")


def _steps_in(d: pathlib.Path) -> list[int]:
    return sorted(int(m.group(1)) for p in d.iterdir()
                  if (m := _STEP_RE.match(p.name)))


def latest_step(ckpt_dir: str | os.PathLike) -> int | None:
    d = pathlib.Path(ckpt_dir)
    if not d.exists():
        return None
    steps = _steps_in(d)
    return steps[-1] if steps else None


class CheckpointManager:
    """Step-numbered checkpoints with retention."""

    def __init__(self, ckpt_dir: str | os.PathLike, keep: int = 3):
        self.dir = pathlib.Path(ckpt_dir)
        self.keep = keep

    def path(self, step: int) -> pathlib.Path:
        return self.dir / f"step_{step}.msgpack"

    def save(self, step: int, tree) -> None:
        save_pytree(self.path(step), tree)
        for s in _steps_in(self.dir)[:-self.keep]:
            self.path(s).unlink(missing_ok=True)

    def restore(self, step: int | None = None):
        if step is None:
            step = latest_step(self.dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        return step, restore_pytree(self.path(step))

    def steps(self) -> list[int]:
        """All retained step numbers, ascending."""
        if not self.dir.exists():
            return []
        return _steps_in(self.dir)


# ---------------------------------------------------------------------------
# FL checkpoints: per-silo flat rows + run metadata, the exchange format
# between training and serving: the (N, T) flat parameter block in the
# single-device layout, plus what a consumer needs to rebuild the model
# around the rows (network / topology / multiplicity, the training round
# and its simulated wall clock, a short loss tail).
# ---------------------------------------------------------------------------

_FL_KIND = "fl_flat_rows"


@dataclasses.dataclass(frozen=True)
class FLCheckpoint:
    """One restored FL checkpoint."""

    step: int
    w: np.ndarray        # (N, T) f32 per-silo flat parameter rows
    meta: dict

    @property
    def num_silos(self) -> int:
        return int(self.w.shape[0])


def save_fl_checkpoint(manager: CheckpointManager, step: int, w,
                       **meta) -> None:
    """Save per-silo flat rows ``w`` (an (N, T) array or tensor, on any
    device) and metadata as step ``step``; metadata values must be
    scalars, strings, lists, tuples, dicts or arrays."""
    if not isinstance(w, torch.Tensor):
        w = np.asarray(w)
    if w.ndim != 2:
        raise ValueError(f"w must be (N, T) flat rows, got {tuple(w.shape)}")
    meta = dict(meta, round=int(meta.get("round", step)))
    manager.save(step, {"kind": _FL_KIND, "w": w,
                        "meta": _encode_meta(meta)})


def load_fl_checkpoint(src, step: int | None = None) -> FLCheckpoint:
    """Restore an `FLCheckpoint` from a `CheckpointManager` or dir."""
    manager = src if isinstance(src, CheckpointManager) \
        else CheckpointManager(src)
    step, tree = manager.restore(step)
    if not isinstance(tree, dict) or tree.get("kind") != _FL_KIND:
        raise ValueError(f"step {step} in {manager.dir} is not an FL "
                         f"checkpoint (kind={tree.get('kind')!r})")
    return FLCheckpoint(step=int(step), w=np.asarray(tree["w"]),
                        meta=dict(tree["meta"]))


def _encode_meta(meta: dict) -> dict:
    """Round-trippable metadata: tuples -> lists, numpy scalars -> Python
    numbers, arrays pass through."""
    def enc(v):
        if isinstance(v, tuple):
            return [enc(x) for x in v]
        if isinstance(v, dict):
            return {k: enc(x) for k, x in v.items()}
        if isinstance(v, np.integer):
            return int(v)
        if isinstance(v, np.floating):
            return float(v)
        return v
    return {k: enc(v) for k, v in meta.items()}
