"""Kernel designs of the fused refresh-and-aggregate, timed side by side
on one card at the shapes of chip_smoke.py's phase edge_aggregate.

    python3 tools/edge_aggregate_probe/probe.py [OUT.jsonl]

Needs a CUDA card and nvcc. Builds every variant at once (one nvcc each,
into tools/edge_aggregate_probe/build/), prints one JSON line per build
(the ptxas register report) and per shape, and appends the shape lines
to OUT.jsonl when given. The variants:

* ``kept``: the repo's kernel (`src/repro_torch/csrc/edge_aggregate.cu`)
  through `ops.refresh_aggregate`: one CTA per (destination row,
  1,024-column tile) of any segment, row fastest, two edges' loads in
  flight together (kBatch 2), at least 8 CTAs an SM (kMinCtas).
* ``kept_batch1``, ``kept_batch4``: the same source with kBatch 1, and
  with kBatch 4 and kMinCtas 6.
* ``rows4``, ``rows2``: rows.cu, the kept layout before the batched
  loads, 4 or 2 columns a thread.
* ``staged``: staged.cu, the tile-owning design. A persistent grid (the
  CTAs resident at once, 2 an SM) walks (segment, column tile) items; a
  CTA owns its tile across all N rows of the segment. Each thread
  cp.asyncs its columns of the N rows of w, of each weak edge's buffer
  row and (when fresh is not w) of each strong edge's fresh row into
  shared memory, all in flight at once, waits for its own copies, then
  sums each destination's edges from shared memory and writes the output
  and the strong buffer rows from registers. The slab is at most 113 KB
  (256 threads x 4, 2 or 1 columns, the widest that fits); a segment
  whose slab would not fit is read with plain loads.
* ``staged_4cta``: the same with a 56 KB slab and 4 CTAs an SM.
* ``w_only``: staged.cu with only w's tile staged (1,024 columns at
  N = 11 is 45 KB); buffer rows by plain vector loads.
* ``direct``: staged.cu's persistent tile-owning grid with nothing
  staged: every row by plain vector loads.

Beside them, at one-segment shapes, the aggregation alone (no refresh)
of ``parent`` (parent.cu: the kernel before the refresh was fused in) and
of the kept kernel (`ops.edge_aggregate`), on the same inputs. Every
variant's outputs and refreshed buffers are held against the plain
version bit for bit (``equal``). ``ms`` is the device time per call in a
replayed CUDA graph over copies of the inputs that together pass twice
the L2 cache (chip_smoke.graph_ms); ``eager_ms`` back-to-back calls on
one set by events. ``bound_ms`` is chip_smoke._fused_work's bytes and
flops over the card's rates.
"""

from __future__ import annotations

import array
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402
from repro_torch.configs import get_config, reduce  # noqa: E402
from repro_torch.core.delay import WORKLOADS  # noqa: E402
from repro_torch.fl.dpasgd import make_round_schedule  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.gossip_combine import ops  # noqa: E402
from repro_torch.kernels.gossip_combine.ref import \
    refresh_aggregate_ref  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.mesh import tree_leaves  # noqa: E402
from repro_torch.networks.registry import get_network  # noqa: E402

BUILD = HERE / "build"
KEPT = ROOT / "src" / "repro_torch" / "csrc" / "edge_aggregate.cu"
#: name -> (source, flags, {text: replacement} applied to a copy)
VARIANTS = {
    "kept_batch1": (KEPT, [], {"kBatch = 2;": "kBatch = 1;"}),
    "kept_batch4": (KEPT, [], {"kBatch = 2;": "kBatch = 4;",
                               "kMinCtas = 8;": "kMinCtas = 6;"}),
    "rows4": (HERE / "rows.cu", ["-DEA_ROW_COLS=4"], {}),
    "rows2": (HERE / "rows.cu", ["-DEA_ROW_COLS=2"], {}),
    "staged": (HERE / "staged.cu", [], {}),
    "staged_4cta": (HERE / "staged.cu", ["-DEA_SMEM_TARGET=57344",
                                         "-DEA_MIN_BLOCKS=4"], {}),
    "w_only": (HERE / "staged.cu", ["-DEA_W_ONLY"], {}),
    "direct": (HERE / "staged.cu", ["-DEA_FORCE_DIRECT"], {}),
    "parent": (HERE / "parent.cu", [], {}),
}


def build_all() -> dict[str, ctypes.CDLL]:
    BUILD.mkdir(exist_ok=True)
    procs = {}
    for name, (src, flags, edits) in VARIANTS.items():
        if edits:
            text = src.read_text()
            for a, b in edits.items():
                if a not in text:
                    raise SystemExit(f"{name}: {a!r} is not in {src.name}")
                text = text.replace(a, b)
            src = BUILD / f"{name}.cu"
            src.write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, *flags, "-o",
             str(BUILD / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        print(json.dumps(dict(build=name, rc=proc.returncode, ptxas=[
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "error" in ln])), flush=True)
        if proc.returncode:
            raise SystemExit(f"{name} did not build")
        libs[name] = ctypes.CDLL(str(BUILD / f"{name}.so"))
    return libs


def segment_call(lib, layout: str):
    """A call of a variant's entry over a list of `Segment`s. ``layout``
    "kept": the repo's 13-word record and entry (`ops._record`);
    "probe": staged.cu's and rows.cu's 14-word record (edges beside n,
    vec, staged and first filled by the entry) with a ``cols`` argument
    (0: the entry picks)."""
    fn = lib.edge_aggregate_segments
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                   if layout == "kept" else
                   [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def call(segs):
        outs = [torch.empty_like(s.w) for s in segs]
        words = array.array("q")
        for s, out in zip(segs, outs):
            rec = ops._record(s, out)
            if layout == "probe":
                rec = rec[:11] + [s.w.shape[0] | s.coeffs.shape[0] << 32,
                                  0, 0]
            words.extend(rec)
        stream = torch.cuda.current_stream().cuda_stream
        rc = (fn(words.buffer_info()[0], len(segs), stream)
              if layout == "kept" else
              fn(words.buffer_info()[0], len(segs), 0, stream))
        if rc:
            raise RuntimeError(f"launch failed, cudaError {rc}")
        return outs

    return call


def parent_call(lib):
    fn = lib.edge_aggregate_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64, ctypes.c_int64,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(s):
        out = torch.empty_like(s.w)
        rc = fn(s.w.data_ptr(), s.buf.data_ptr(), s.coeffs.data_ptr(),
                s.row_ptr.data_ptr(), s.diag.data_ptr(), out.data_ptr(),
                s.w.shape[0], s.w.shape[1],
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"parent launch failed, cudaError {rc}")
        return out

    return call


def shapes(gen):
    """(name, segments) at the phase's shapes, made one at a time."""
    for name in ("femnist_multigraph", "lstm_multigraph",
                 "resnet_multigraph", "femnist_wan64"):
        network, wl, topology, width = cs.EA_SHAPES[name]
        net = get_network(network)
        plan, _ = make_round_schedule(topology, net, WORKLOADS[wl],
                                      rounds=cs.ROUNDS)
        seg, _ = cs._flat_segment(torch, plan, 1 % plan.num_rounds_cycle,
                                  net.num_silos, width, gen)
        yield name, [seg]
    cfg = train.TrainConfig()
    net4 = train._sub_network(train.get_network(cfg.network), cfg.silos)
    plan4, _ = make_round_schedule("multigraph", net4, WORKLOADS["femnist"],
                                   t=cfg.t, rounds=cfg.rounds)
    sizes = [x.numel() for x in tree_leaves(train.initial_params(
        reduce(get_config(cfg.arch)), 0, "cpu"))]
    segs, _ = cs._leaf_segments(torch, plan4, 1, net4.num_silos, sizes, gen)
    yield "mamba2_largest_leaf", [max(segs, key=lambda s: s.w.shape[1])]
    yield "mamba2_leaves", segs
    gaia = get_network("gaia")
    plan, _ = make_round_schedule("multigraph", gaia, WORKLOADS["femnist"])
    segs, _, _ = cs._mesh_segments(torch, plan, 1, gaia.num_silos,
                                   cs.MAIN_SHAPE["t"], cs.MESH_ROW_SHARDS,
                                   gen)
    for s in segs:  # NaN pads are never read, but zero them for timing
        for x in (s.w, s.buf, s.fresh):
            torch.nan_to_num_(x, nan=0.0)
    yield "mesh_shards", segs


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    out = Path(sys.argv[1]) if len(sys.argv) > 1 else None
    kind = torch.cuda.get_device_name(0)
    smi = cs.nvidia_smi_line()
    print(json.dumps(dict(card=kind, nvidia_smi=smi)), flush=True)
    libs = build_all()
    calls = {"kept": ops.refresh_aggregate}
    for name in VARIANTS:
        if name != "parent":
            calls[name] = segment_call(
                libs[name], "kept" if name.startswith("kept") else "probe")
    parent = parent_call(libs["parent"])
    bw, fp32, _ = cs.card_rates(kind)
    gen = torch.Generator(device="cuda").manual_seed(1)
    for name, segs in shapes(gen):
        nbytes, flops = cs._fused_work(segs)
        copies = [segs] + [[s._replace(**{k: getattr(s, k).clone() for k in (
            "w", "buf", "fresh") if getattr(s, k) is not None}) for s in segs]
            for _ in range(math.ceil(cs.EA_COLD_BYTES / nbytes) - 1)]
        want_bufs = [s.buf.clone() for s in segs]
        want = refresh_aggregate_ref(
            [s._replace(buf=b) for s, b in zip(segs, want_bufs)])
        row = dict(shape=name, segments=len(segs),
                   t=[s.w.shape[1] for s in segs],
                   bound_ms=max(nbytes / bw, flops / fp32) * 1e3,
                   nvidia_smi=smi, variants={})
        for vname, fn in calls.items():
            bufs = [s.buf.clone() for s in segs]
            got = fn([s._replace(buf=b) for s, b in zip(segs, bufs)])
            torch.cuda.synchronize()
            equal = all(torch.equal(a, b) for a, b in zip(got, want)) and all(
                torch.equal(a, b) for a, b in zip(bufs, want_bufs))
            del got, bufs
            row["variants"][vname] = dict(
                equal=equal,
                ms=cs.graph_ms(torch, [lambda c=c, f=fn: f(c)
                                       for c in copies]),
                eager_ms=cs.cuda_ms(torch, lambda f=fn: f(segs), 20))
        if len(segs) == 1:
            s = segs[0]
            agg = [c[0] for c in copies]
            row["aggregate_only"] = {
                "parent": dict(
                    ms=cs.graph_ms(torch, [lambda x=x: parent(x)
                                           for x in agg]),
                    eager_ms=cs.cuda_ms(torch, lambda: parent(s), 20)),
                "kept": dict(
                    ms=cs.graph_ms(torch, [lambda x=x: ops.edge_aggregate(
                        x.w, x.buf, x.coeffs, x.row_ptr, x.diag)
                        for x in agg]),
                    eager_ms=cs.cuda_ms(torch, lambda: ops.edge_aggregate(
                        s.w, s.buf, s.coeffs, s.row_ptr, s.diag), 20))}
            if not torch.equal(parent(s), ops.edge_aggregate(
                    s.w, s.buf, s.coeffs, s.row_ptr, s.diag)):
                raise AssertionError(f"{name}: the parent kernel and the "
                                     "kept one differ without refresh")
        line = json.dumps(row)
        print(line, flush=True)
        if out is not None:
            with out.open("a") as f:
                f.write(line + "\n")
        del segs, copies, want, want_bufs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
