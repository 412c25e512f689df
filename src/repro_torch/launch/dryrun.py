"""Dry run on the host: trace every (arch x shape x mesh) step once on
fake tensors (counterpart of `repro.launch.dryrun`).

The reference lowers and compiles each pair for a 256- or 512-chip TPU
mesh and reads XLA's memory and cost analyses. The port's meshes:

* "h100" (`make_train_step`, `make_prefill_step`, `make_serve_step`) and
  "h100_fl2" (train shapes: `make_fl_train_step` over FL_SILOS = 2 silos
  stacked on one card; the other shapes as on "h100"): one card;
* "h100x256" and "h100x512": the reference's production meshes, (16, 16)
  ("data", "model") and (2, 16, 16) ("pod", "data", "model"), with
  ``debug=True`` (2, 2) and (2, 2, 2). The step runs as rank 0 of a
  `fake_world` of the mesh's size on DTensor inputs laid out by
  `launch/sharding` (FSDP and tensor-parallel specs, `fsdp_layers`,
  `kv_seq_shard`), built from their local shards without a collective,
  with the reference's activation anchors (`models/shard_ctx`) in train
  and prefill. Multi-pod train is the FL step over FL_SILOS silos with
  the silo axis over "pod" (`param_specs(pod_stacked=True)`).

Each step runs once, eagerly, on the inputs of `launch/specs`
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
* ``collectives``: on the sharded meshes, `hlo_analysis.CollectiveCounter`'s
  summary of the step on rank 0: operand bytes and counts per kind, and
  bytes per mesh axis (``by_axis``). Zero on "h100" and "h100_fl2",
  where every silo sits on one card. The mesh runtime's shard layout has
  reports of its own (`dry_fl_mesh`).
* On the sharded meshes every FLOP, byte and memory figure is rank 0's:
  its local ops and the storages of its shards (the reference's
  per-device figures).
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

  python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k \
      --mesh h100x256 --layers 1 [--debug]

Each op of a step is a Python call on fake tensors, so a full-depth
train_4k pair takes minutes; --jobs traces pairs in parallel processes
and --layers N cuts every model's depth for a quick check. --debug
shrinks the sharded meshes to (2, 2) and (2, 2, 2), the reference's CI
meshes.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import multiprocessing
import pathlib
import time
import traceback
import weakref
from concurrent.futures import ProcessPoolExecutor

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import hlo_analysis, roofline
from repro_torch.launch import sharding as shrules
from repro_torch.launch.mesh import fake_world, make_debug_mesh, tree_map
from repro_torch.launch.specs import (SHAPES, InputShape, batch_shape,
                                      decode_shapes, meta_leaves,
                                      params_shape, shape_applicable)
from repro_torch.launch.steps import (make_fl_train_step, make_prefill_step,
                                      make_serve_step, make_train_step)
from repro_torch.models import shard_ctx
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw

FL_SILOS = 2  # "h100_fl2" / "h100x512": two silos of the FL round
#: one card
CARD_MESHES = ("h100", "h100_fl2")
#: mesh name -> (shape, debug shape, axis names), on a fake world
SHARDED_MESHES = {
    "h100x256": ((16, 16), (2, 2), ("data", "model")),
    "h100x512": ((2, 16, 16), (2, 2, 2), ("pod", "data", "model")),
}
MESHES = CARD_MESHES + tuple(SHARDED_MESHES)
#: --mesh names that stand for several meshes
MESH_SETS = {"both": CARD_MESHES, "all": MESHES}
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
            self._add(_local(t).untyped_storage())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # meter rank 0's local ops instead
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


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def storage_bytes(tensors) -> int:
    """Bytes of the distinct storages under ``tensors`` (a DTensor's: its
    local shard's)."""
    seen = {}
    for t in tensors:
        st = _local(t).untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


def _fake(tree):
    """Meta tree -> the same tree of fresh (fake, under the mode) tensors."""
    if isinstance(tree, dict):
        return {k: _fake(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_fake(v) for v in tree]
    return torch.empty(tree.shape, dtype=tree.dtype, device="cpu")


def measure(step, make_args, counter=None) -> dict:
    """Run ``step(*make_args())`` once on fake tensors: FLOPs, bytes
    accessed, argument / output / peak / temp bytes and seconds; with a
    `hlo_analysis.CollectiveCounter`, the step's collectives too."""
    t0 = time.perf_counter()
    # real tensors made when the step was built (the FL consensus
    # matrix) are faked where they meet the inputs
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = make_args()
        arg_tensors = meta_leaves(list(args))
        meter = _StepMeter()
        meter.hold(arg_tensors)
        with meter, (counter or contextlib.nullcontext()):
            out = step(*args)
        argument_bytes = storage_bytes(arg_tensors)
        output_bytes = storage_bytes(meta_leaves(out))
        del out
    rep = dict(
        trace_s=time.perf_counter() - t0,
        memory=dict(argument_bytes=argument_bytes, output_bytes=output_bytes,
                    temp_bytes=meter.peak - argument_bytes,
                    peak_bytes=meter.peak, generated_code_bytes=None),
        cost=dict(flops=float(meter.flops),
                  bytes_accessed=float(meter.accessed)))
    if counter is not None:
        rep["collectives"] = counter.stats().summary()
    return rep


ANCHORS = dict(act=shrules.P("data", None, None),
               channels=shrules.P("data", None, "model"),
               heads=shrules.P("data", None, "model", None))


def _build(cfg: ModelConfig, shape: InputShape, *, fl: bool, gossip: bool,
           impl: str, remat: bool, microbatch: int, gossip_dtype: str,
           grad_dtype: str | None, mesh=None, fsdp_layers: bool = True,
           kv_seq_shard: bool = False):
    """(step, make_args) of one pair; make_args runs under the fake mode.
    ``fl``: a train shape takes the FL step over FL_SILOS stacked silos.
    With a `DeviceMesh` the inputs are DTensors under the specs of
    `launch/sharding`, made from this rank's shards with no collective;
    without, plain fake tensors."""
    multi_pod = mesh is not None and "pod" in mesh.mesh_dim_names

    def specs(rule, *args, **kw):
        return None if mesh is None else rule(*args, **kw)

    def inputs(tree, spec_tree):
        if mesh is None:
            return _fake(tree)
        return shrules.spec_map(lambda meta, spec: shrules.sharded(
            torch.empty(shrules.local_shape(meta.shape, mesh, spec),
                        dtype=meta.dtype), mesh, spec, tuple(meta.shape)),
            tree, spec_tree)

    pshape = params_shape(cfg)
    if shape.mode == "train":
        opt = adamw(1e-4)
        if fl:
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
        pspec = specs(shrules.param_specs, cfg, pshape,
                      fsdp_layers=fsdp_layers, pod_stacked=fl, mesh=mesh)
        bspec = specs(shrules.batch_specs, "train", multi_pod=multi_pod,
                      fl=fl, has_prefix="prefix_embeds" in bshape)

        def make_args():
            params = inputs(pshape, pspec)
            return params, opt.init(params), inputs(bshape, bspec)

        return step, make_args
    pspec = specs(shrules.param_specs, cfg, pshape, fsdp_layers=fsdp_layers,
                  mesh=mesh)
    if shape.mode == "prefill":
        bshape = batch_shape(cfg, shape)
        bshape.pop("labels")
        bspec = specs(shrules.batch_specs, "prefill", multi_pod=multi_pod,
                      fl=False, has_prefix="prefix_embeds" in bshape)
        return make_prefill_step(cfg, impl=impl), \
            lambda: (inputs(pshape, pspec), inputs(bshape, bspec))
    tokens, state = decode_shapes(cfg, shape)
    sspec = specs(shrules.decode_cache_specs, cfg, state,
                  batch=shape.global_batch, multi_pod=multi_pod, mesh=mesh,
                  kv_seq_shard=kv_seq_shard)
    daxis = ("pod", "data") if multi_pod else "data"
    tspec = (shrules.P(daxis, None) if shape.global_batch > 1
             else shrules.P(None, None))

    def make_args():
        # the last position: the whole context is live; an int, which
        # `decode_step` reads on the host without a value from the tensors
        st = tf.DecodeState(caches=inputs(state.caches,
                                          sspec and sspec.caches),
                            position=shape.seq_len - 1)
        return inputs(pshape, pspec), inputs(tokens, tspec), st

    return make_serve_step(cfg, impl=impl), make_args


def _measure_sharded(cfg: ModelConfig, shape: InputShape, mesh_name: str, *,
                     debug: bool, **kw) -> dict:
    """`measure` as rank 0 of a fake world of the mesh's size, the
    activation anchors set for train and prefill, collectives counted."""
    from torch.distributed.tensor.experimental import implicit_replication

    full, small, axes = SHARDED_MESHES[mesh_name]
    mesh_shape = small if debug else full
    with fake_world(math.prod(mesh_shape)):
        mesh = make_debug_mesh(mesh_shape, axes, device_type="cpu")
        step, make_args = _build(cfg, shape, fl="pod" in axes, mesh=mesh,
                                 **kw)

        def run(*args):
            with implicit_replication():
                return step(*args)

        if shape.mode in ("train", "prefill"):
            shard_ctx.set_specs(**ANCHORS, mesh=mesh)
        try:
            rep = measure(run, make_args,
                          hlo_analysis.CollectiveCounter(mesh))
        finally:
            shard_ctx.clear()
    rep["mesh_shape"] = list(mesh_shape)
    return rep


def dry_pair(arch: str | ModelConfig, shape: str | InputShape,
             mesh: str = "h100", *, gossip: bool = True,
             impl: str = "chunked", remat: bool = True, microbatch: int = 8,
             gossip_dtype: str = "float32", grad_dtype: str | None = None,
             layers: int | None = None, fsdp_layers: bool = True,
             kv_seq_shard: bool = False, debug: bool = False) -> dict:
    """Trace one (arch, shape, mesh) on fake tensors (the reference's
    `lower_pair`). ``arch`` and ``shape`` are names or a config and an
    `InputShape`. microbatch=8 is the reference's baseline for train
    shapes (gradient accumulation over 8 slices of the batch).
    ``layers`` cuts the model's depth (the report says so under
    "layers"): each layer costs the host about a second of eager Python
    per microbatch at 4k tokens, so a full-depth train_4k pair takes
    minutes. ``fsdp_layers``, ``kv_seq_shard`` and ``debug`` (the (2, 2)
    and (2, 2, 2) meshes) act on the sharded meshes only."""
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
    microbatch = microbatch if shape.mode == "train" else 1
    try:
        if mesh in SHARDED_MESHES:
            report.update(status="ok", **_measure_sharded(
                cfg, shape, mesh, debug=debug, gossip=gossip, impl=impl,
                remat=remat, microbatch=microbatch,
                gossip_dtype=gossip_dtype, grad_dtype=grad_dtype,
                fsdp_layers=fsdp_layers, kv_seq_shard=kv_seq_shard),
                while_trips=hlo_analysis.while_trip_counts())
        else:
            step, make_args = _build(
                cfg, shape, fl=mesh == "h100_fl2", gossip=gossip, impl=impl,
                remat=remat, microbatch=microbatch,
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
    """Every arch x shape on the meshes of ``mesh_kind`` (a mesh or a key
    of MESH_SETS) into ``out_dir`` (a pair whose report exists is
    read back), in ``jobs`` processes (each pair is one single-threaded
    eager trace), then every arch's mesh-runtime layouts at ``fl_shards``
    into ``out_dir/fl_mesh``. ``kw`` goes to `dry_pair`."""
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = archs or ARCH_IDS
    shapes = shapes or list(SHAPES)
    meshes = MESH_SETS.get(mesh_kind, (mesh_kind,))
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
    ap.add_argument("--mesh", choices=[*MESHES, *MESH_SETS],
                    default="h100",
                    help="a mesh, or both (the two card meshes), sharded "
                         "(h100x256 and h100x512) or all")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--debug", action="store_true",
                    help="the sharded meshes at (2, 2) and (2, 2, 2)")
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
        reps = run_all(args.mesh, out, jobs=args.jobs, layers=args.layers,
                       debug=args.debug)
        return int(any(r["status"] == "error" for r in reps))
    if not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    out.mkdir(parents=True, exist_ok=True)
    failed = False
    for mesh in MESH_SETS.get(args.mesh, (args.mesh,)):
        rep = dry_pair(args.arch, args.shape, mesh,
                       gossip=not args.no_gossip, layers=args.layers,
                       debug=args.debug)
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
