"""Dry run on the host: trace every (arch x shape x mesh) step once on
fake tensors (counterpart of `repro.launch.dryrun`).

The reference lowers and compiles each pair for a 256- or 512-chip TPU
mesh and reads XLA's memory and cost analyses. The port runs on one
H100, so its meshes are "h100" (`make_train_step`, `make_prefill_step`,
`make_serve_step`) and "h100_fl2" (train shapes: `make_fl_train_step`
over FL_SILOS = 2 silos stacked on one card; the other shapes as on
"h100"). Each step runs once, eagerly, on the inputs of `launch/specs`
materialised as fake tensors (`FakeTensorMode`: shapes and types, no
storage), so full-size configs run on any host. The impl is "chunked" by
default, as in the reference: the port's kernels are `ctypes` calls that
neither fake tensors nor `FlopCounterMode` can enter.

Per pair the report keeps the reference's keys:

* ``cost.flops``: the FLOPs of `torch.utils.flop_counter`'s formulas,
  the count `FlopCounterMode` gives (matmuls, convolutions and
  attention; elementwise ops count 0), summed by `_StepMeter`, one
  dispatch mode of this module that meters FLOPs, bytes and live
  storage together at about half of `FlopCounterMode`'s own cost.
  ``cost.bytes_accessed``: the bytes of every tensor each non-view aten
  op reads and writes, summed over the ops (XLA's per-HLO definition).
* ``memory.argument_bytes`` / ``output_bytes``: exact sums over the
  distinct storages of the step's inputs and outputs (decode outputs
  alias the caches, which count in both). ``memory.peak_bytes``: the most
  bytes live at once during the step, arguments included: `_StepMeter`
  adds each new storage when an op creates it and subtracts it when it
  is freed.
  ``memory.temp_bytes`` = peak_bytes - argument_bytes. XLA's temp is the
  size of its scheduled scratch buffer, outputs and donated arguments
  excluded; this one is what the eager caching allocator would need on
  top of the arguments, outputs included, without its block rounding
  and fragmentation.
* ``collectives``: zero bytes on "h100" and "h100_fl2", where every
  silo sits on one card (the reference parses them from the HLO,
  `hlo_analysis.py`, which has no torch counterpart). The mesh runtime's
  shard layout has reports of its own (`dry_fl_mesh`).
* ``trace_s``: seconds to build the inputs and run the step, in place of
  ``lower_s`` and ``compile_s``.
* ``memory.generated_code_bytes`` is null and ``while_trips`` is {}:
  eager PyTorch generates no program and unrolls its loops in Python.

`dry_fl_mesh` dry-runs the mesh runtime's per-shard state for a D-shard
layout: the flat w, momentum and the shard's padded edge-buffer rows,
allocated by `fl/mesh.init_mesh_state` on fake tensors, must sum to
`roofline.fl_mesh_report`'s state bytes, and its collectives are the
report's per-device bytes beside the runtime's `fabric_bytes`.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k --mesh h100
  python -m repro_torch.launch.dryrun --all --mesh both --jobs 6 \
      --out experiments/dryrun_torch

Each op of a step is a Python call on fake tensors, so a full-depth
train_4k pair takes minutes; --jobs traces pairs in parallel processes
and --layers N cuts every model's depth for a quick check. The
reference's --debug (a 4- or 8-device host mesh) has no counterpart:
the port has no device mesh to shrink.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import pathlib
import time
import traceback
import weakref
from concurrent.futures import ProcessPoolExecutor

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import roofline
from repro_torch.launch.mesh import tree_map
from repro_torch.launch.specs import (SHAPES, InputShape, batch_shape,
                                      decode_shapes, meta_leaves,
                                      params_shape, shape_applicable)
from repro_torch.launch.steps import (make_fl_train_step, make_prefill_step,
                                      make_serve_step, make_train_step)
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw

FL_SILOS = 2  # "h100_fl2": two silos of the FL round on one card
MESHES = ("h100", "h100_fl2")
FL_SHARDS = (1, 2, 4, 8)  # the mesh runtime's layouts `run_all` prices


class _StepMeter(TorchDispatchMode):
    """One dispatch mode that meters the ops run under it:

    * ``flops``: `torch.utils.flop_counter`'s formulas (`flop_registry`,
      what `FlopCounterMode` sums) for every op that has one;
    * ``live`` / ``peak``: bytes of the distinct storages alive, and their
      most, counting the storages `hold` is given, each storage an op
      creates from then on, and subtracting each when it is freed;
    * ``accessed``: the bytes of the tensors every non-view op reads and
      writes.

    Ops of the ``prim`` namespace (a fake tensor's device query) pass
    straight through."""

    def __init__(self):
        super().__init__()
        self.flops = self.live = self.peak = self.accessed = 0
        self._seen = WeakIdKeyDictionary()

    def _add(self, st) -> None:
        if st in self._seen:
            return
        n = st.nbytes()
        self._seen[st] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def hold(self, tensors) -> None:
        for t in tensors:
            self._add(t.untyped_storage())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "prim":
            return out
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns):
            return out  # a view: no new storage, no bytes moved
        outs = out if isinstance(out, (tuple, list)) else (out,)
        nbytes = 0
        for x in (*args, *outs):
            for t in (x if isinstance(x, (tuple, list)) else (x,)):
                if isinstance(t, torch.Tensor):
                    nbytes += t.numel() * t.element_size()
        self.accessed += nbytes
        for t in outs:
            if isinstance(t, torch.Tensor):
                self._add(t.untyped_storage())
        return out


def storage_bytes(tensors) -> int:
    """Bytes of the distinct storages under ``tensors``."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


def _fake(tree):
    """Meta tree -> the same tree of fresh (fake, under the mode) tensors."""
    if isinstance(tree, dict):
        return {k: _fake(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_fake(v) for v in tree]
    return torch.empty(tree.shape, dtype=tree.dtype, device="cpu")


def measure(step, make_args) -> dict:
    """Run ``step(*make_args())`` once on fake tensors: FLOPs, bytes
    accessed, argument / output / peak / temp bytes and seconds."""
    t0 = time.perf_counter()
    # real tensors made when the step was built (the FL consensus
    # matrix) are faked where they meet the inputs
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = make_args()
        arg_tensors = meta_leaves(list(args))
        meter = _StepMeter()
        meter.hold(arg_tensors)
        with meter:
            out = step(*args)
        argument_bytes = storage_bytes(arg_tensors)
        output_bytes = storage_bytes(meta_leaves(out))
        del out
    return dict(
        trace_s=time.perf_counter() - t0,
        memory=dict(argument_bytes=argument_bytes, output_bytes=output_bytes,
                    temp_bytes=meter.peak - argument_bytes,
                    peak_bytes=meter.peak, generated_code_bytes=None),
        cost=dict(flops=float(meter.flops),
                  bytes_accessed=float(meter.accessed)))


def _build(cfg: ModelConfig, shape: InputShape, mesh: str, *, gossip: bool,
           impl: str, remat: bool, microbatch: int, gossip_dtype: str,
           grad_dtype: str | None):
    """(step, make_args) of one pair; make_args runs under the fake mode."""
    pshape = params_shape(cfg)
    if shape.mode == "train":
        opt = adamw(1e-4)
        if mesh == "h100_fl2":
            pshape = tree_map(lambda x: torch.empty(
                (FL_SILOS,) + tuple(x.shape), dtype=x.dtype, device="meta"),
                pshape)
            step = make_fl_train_step(
                cfg, FL_SILOS, opt, impl=impl, remat=remat, gossip=gossip,
                microbatch=microbatch, gossip_dtype=gossip_dtype,
                grad_dtype=grad_dtype)
            bshape = batch_shape(cfg, shape, fl_silos=FL_SILOS)
        else:
            step = make_train_step(cfg, opt, impl=impl, remat=remat,
                                   microbatch=microbatch)
            bshape = batch_shape(cfg, shape)

        def make_args():
            params = _fake(pshape)
            return params, opt.init(params), _fake(bshape)

        return step, make_args
    if shape.mode == "prefill":
        bshape = batch_shape(cfg, shape)
        bshape.pop("labels")
        return make_prefill_step(cfg, impl=impl), \
            lambda: (_fake(pshape), _fake(bshape))
    tokens, state = decode_shapes(cfg, shape)

    def make_args():
        # the last position: the whole context is live; an int, which
        # `decode_step` reads on the host without a value from the tensors
        st = tf.DecodeState(caches=_fake(state.caches),
                            position=shape.seq_len - 1)
        return _fake(pshape), _fake(tokens), st

    return make_serve_step(cfg, impl=impl), make_args


def dry_pair(arch: str | ModelConfig, shape: str | InputShape,
             mesh: str = "h100", *, gossip: bool = True,
             impl: str = "chunked", remat: bool = True, microbatch: int = 8,
             gossip_dtype: str = "float32", grad_dtype: str | None = None,
             layers: int | None = None) -> dict:
    """Trace one (arch, shape, mesh) on fake tensors (the reference's
    `lower_pair`). ``arch`` and ``shape`` are names or a config and an
    `InputShape`. microbatch=8 is the reference's baseline for train
    shapes (gradient accumulation over 8 slices of the batch).
    ``layers`` cuts the model's depth (the report says so under
    "layers"): each layer costs the host about a second of eager Python
    per microbatch at 4k tokens, so a full-depth train_4k pair takes
    minutes."""
    if mesh not in MESHES:
        raise ValueError(f"unknown mesh {mesh!r}; have {MESHES}")
    cfg = get_config(arch) if isinstance(arch, str) else arch
    if layers is not None:  # a hybrid keeps one application of its block
        cfg = dataclasses.replace(cfg, num_layers=max(
            layers, cfg.attn_every if cfg.family == "hybrid" else 1))
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    ok, why = shape_applicable(cfg, shape)
    report = {"arch": arch if isinstance(arch, str) else cfg.name,
              "shape": shape.name, "mesh": mesh, "mode": shape.mode,
              "family": cfg.family, "layers": cfg.num_layers,
              "params": cfg.param_count(),
              "active_params": cfg.active_param_count()}
    if not ok:
        report.update(status="skipped", reason=why)
        return report
    try:
        step, make_args = _build(
            cfg, shape, mesh, gossip=gossip, impl=impl, remat=remat,
            microbatch=microbatch if shape.mode == "train" else 1,
            gossip_dtype=gossip_dtype, grad_dtype=grad_dtype)
        report.update(status="ok", **measure(step, make_args),
                      collectives={"total_bytes": 0, "by_kind": {},
                                   "counts": {}},
                      while_trips={})
    except Exception as e:  # noqa: BLE001 -- a pair's failure is its report
        report.update(status="error", error=f"{type(e).__name__}: {e}",
                      trace=traceback.format_exc()[-3000:])
    return report


def fl_mesh_state_bytes(arch: str, *, network: str = "gaia",
                        num_shards: int = 8, rank: int = 8) -> dict:
    """One shard's flat FL state (w, momentum, its padded edge-buffer
    rows) as `fl/mesh.init_mesh_state` allocates it, on fake tensors,
    for the full model (T_full) and the rank-``rank`` LoRA delta
    (T_lora): {"full": bytes, "lora": bytes}."""
    from repro_torch.core import timing
    from repro_torch.core.delay import FEMNIST
    from repro_torch.fl import dpasgd, lora
    from repro_torch.fl.mesh import init_mesh_state, make_mesh_runtime
    from repro_torch.fl.runtime import make_flat_runtime
    from repro_torch.networks import get_network
    from repro_torch.optim import flat_sgd

    net = get_network(network)
    plan, _, _ = dpasgd.multigraph_plan(
        net, timing.multigraph_timing_plan(net, FEMNIST))
    template = params_shape(get_config(arch))
    out = {}
    for kind, tree in (("full", template),
                       ("lora", lora.delta_template(template, rank))):
        mrt = make_mesh_runtime(make_flat_runtime(plan, tree, net.num_silos),
                                num_shards, device="cpu")
        with FakeTensorMode():
            w0 = torch.empty(mrt.rt.spec.size, dtype=torch.float32)
            state = init_mesh_state(w0, flat_sgd(0.1, momentum=0.9), mrt)
            shard0 = [mrt.mspec.split(x)[0] for x in
                      (state.w, state.opt_state["mu"], state.buffers)]
            out[kind] = sum(x.numel() * x.element_size() for x in shard0)
    return out


def dry_fl_mesh(arch: str, num_shards: int, *, network: str = "gaia",
                rank: int = 8) -> dict:
    """The mesh runtime's layout of ``network`` over ``num_shards``
    shards for ``arch``'s full and LoRA state: `fl_mesh_report`, the
    per-shard state bytes allocated on fake tensors (which must equal
    the report's), and the collectives: the report's per-device bytes and
    the runtime's `fabric_bytes` over all shards, per backend."""
    t0 = time.perf_counter()
    rep = roofline.fl_mesh_report(arch, network=network,
                                  num_shards=num_shards, rank=rank)
    state = fl_mesh_state_bytes(arch, network=network,
                                num_shards=num_shards, rank=rank)
    want = {k: rep[k]["state_bytes"] for k in ("full", "lora")}
    coll = {kind: {
        "per_device": rep[kind]["collective_bytes_per_round"],
        "fabric_bytes": {b: roofline.fl_mesh_fabric_bytes(
            rep, b, rep["t_full"] if kind == "full" else rep["t_lora"])
            for b in ("halo", "all_gather")}} for kind in ("full", "lora")}
    report = {"arch": arch, "mesh": f"fl{num_shards}", "network": network,
              "rank": rank, "status": "ok" if state == want else "error",
              "trace_s": time.perf_counter() - t0,
              "memory": {"state_bytes": state}, "collectives": coll,
              "fl_mesh_report": rep}
    if state != want:
        report["error"] = (f"fake-tensor state bytes {state} differ from "
                           f"fl_mesh_report's {want}")
    return report


def _print_line(rep: dict) -> None:
    status = rep["status"]
    extra = (f" trace={rep['trace_s']:.1f}s "
             f"flops={rep['cost']['flops']:.3g} "
             f"peak={rep['memory']['peak_bytes']:.3g}B"
             if status == "ok" else " " + rep.get("reason",
                                                  rep.get("error", "")))
    print(f"[dryrun] {rep['mesh']} {rep['arch']} {rep['shape']}: "
          f"{status}{extra}", flush=True)


def _pair_to_file(arch: str, shape: str, mesh: str, path: pathlib.Path,
                  kw: dict) -> dict:
    rep = dry_pair(arch, shape, mesh, **kw)
    path.write_text(json.dumps(rep, indent=1))
    _print_line(rep)
    return rep


def run_all(mesh_kind: str, out_dir: pathlib.Path, archs=None, shapes=None,
            fl_shards=FL_SHARDS, jobs: int = 1, **kw) -> list[dict]:
    """Every arch x shape on the meshes of ``mesh_kind`` ("h100",
    "h100_fl2" or "both") into ``out_dir`` (a pair whose report exists is
    read back), in ``jobs`` processes (each pair is one single-threaded
    eager trace), then every arch's mesh-runtime layouts at ``fl_shards``
    into ``out_dir/fl_mesh``. ``kw`` goes to `dry_pair`."""
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = archs or ARCH_IDS
    shapes = shapes or list(SHAPES)
    meshes = MESHES if mesh_kind == "both" else (mesh_kind,)
    results, todo = [], []
    for mesh in meshes:
        for arch in archs:
            for shape in shapes:
                path = out_dir / f"{mesh}__{arch}__{shape}.json"
                if path.exists():
                    print(f"[skip] {path.name} exists")
                    results.append(json.loads(path.read_text()))
                else:
                    todo.append((arch, shape, mesh, path, kw))
    if jobs > 1:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(jobs, mp_context=ctx) as ex:
            # the train pairs take longest: start them first
            todo.sort(key=lambda a: SHAPES[a[1]].mode != "train")
            results += [f.result() for f in
                        [ex.submit(_pair_to_file, *a) for a in todo]]
    else:
        for a in todo:
            print(f"[dryrun] {a[2]} {a[0]} {a[1]} ...", flush=True)
            results.append(_pair_to_file(*a))
    if fl_shards:
        (out_dir / "fl_mesh").mkdir(exist_ok=True)
        for arch in archs:
            for d in fl_shards:
                rep = dry_fl_mesh(arch, d)
                (out_dir / "fl_mesh" / f"fl{d}__{arch}.json").write_text(
                    json.dumps(rep, indent=1))
                print(f"[dryrun] fl{d} {arch}: {rep['status']} "
                      f"{rep.get('error', '')}", flush=True)
                results.append(rep)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", help="architecture id/alias")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=[*MESHES, "both"], default="h100")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-gossip", action="store_true",
                    help="trace a weak (isolated) FL round instead")
    ap.add_argument("--layers", type=int,
                    help="cut every model to this depth (a quick check)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="--all: pairs traced at once, one process each")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    out = pathlib.Path(args.out)
    if args.all:
        reps = run_all(args.mesh, out, jobs=args.jobs, layers=args.layers)
        return int(any(r["status"] == "error" for r in reps))
    if not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    out.mkdir(parents=True, exist_ok=True)
    failed = False
    for mesh in (MESHES if args.mesh == "both" else (args.mesh,)):
        rep = dry_pair(args.arch, args.shape, mesh,
                       gossip=not args.no_gossip, layers=args.layers)
        (out / f"{mesh}__{args.arch}__{args.shape}.json").write_text(
            json.dumps(rep, indent=1))
        print(json.dumps({k: v for k, v in rep.items() if k != "trace"},
                         indent=1))
        if rep["status"] == "error":
            print(rep.get("trace", ""))
            failed = True
    return int(failed)


if __name__ == "__main__":
    raise SystemExit(main())
