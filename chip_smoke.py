#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card, as torch and nvidia-smi name it;
2. build: nvcc builds every CUDA kernel from src/repro_torch/csrc, one
   process per source, all at once;
3. edge_aggregate: the kernel against its plain PyTorch version on the
   card, at the main path's shape (N=11 silos, 2E=22 directed edges of
   the gaia multigraph, T=1,280,478 FEMNIST CNN parameters), on an
   odd-width case with an isolated destination, and at the slice's
   other shapes (EA_SHAPES: the Sent140 LSTM's T=5,070,882 and the
   iNaturalist ResNet's T=11,685,170 over the multigraph, the ResNet on
   MATCHA's complete base graph, 2E=110, and on the star, hub in-degree
   10; FEMNIST's T over the multigraph of the generated 64-silo WAN,
   N=64, 2E=128); the two must agree bit for bit. Times the kernel, the
   plain version and one library call (`torch.addmm` over the dense
   coefficient matrix, a yardstick the port never calls) beside the
   least time the card could take, at every shape;
4. run_fl: the main path, `repro_torch.fl.run_fl` for FEMNIST on gaia
   over the multigraph, two cycles (30 rounds) at full width on the
   card. Launch counts are zeroed just before and read just after; the
   kernel must have run once per round and the losses must be finite.
   A second run aggregating with the plain version must give the same
   losses bit for bit (deterministic algorithms are on for both runs;
   warnings of ops without a deterministic implementation are printed);
5. cycle: one steady-state cycle (15 rounds) timed per aggregator, in
   turns, and a profile of where its device time goes: kernel time by
   name, and the device's idle share against the unprofiled cycle time;
6. flash_attention (this phase and those after it run without the
   deterministic algorithms that run_fl turns on): the kernel against its
   plain PyTorch version on the reference kernel tests' cases, bf16 cases
   of the wgmma route (groups of 3 and 7, S under one key tile, ragged
   tiles, window and prefix edges across tiles, q sliced from a fused
   qkv projection), and the yi-9b prefill shape (B=4, S=2048, Hq=32,
   Hkv=4, hd=128, bf16, causal), within the reference tests' tolerances
   (5e-4 f32, 2e-2 bf16), each case on the route the rule gives it; at
   the prefill shape also against the plain version run in fp32, per row
   (FP32_ROW_REL_TOL); ptxas's registers and spills of the wgmma kernels
   (a spill fails the phase); times the kernel, the plain version and
   `F.scaled_dot_product_attention` (a yardstick the port never calls)
   beside the bound, at the yi-9b shape and at zamba2's (B=4, S=2048,
   Hq=Hkv=32, hd=64);
7. decode_attention: the same on the reference's decode cases, the
   configs' query-head groups (2, 5, 7, 8, 32 and 40 per KV head) and at
   B=8, S=4096 with random lengths (also against fp32); cache rows past
   the lengths are filled with NaN and must not change the result;
   ptxas's spills fail the phase. Timed at S=4096 over DEC_MAIN_COPIES
   copies of the caches, L2-cold, by events around a replayed CUDA graph
   of calls (`graph_ms`), beside SDPA with a boolean length mask (the
   yardstick), the plain version, the bound and the profiler's time; the
   profiler must see one device kernel per call;
8. llm_prefill: yi-9b at full width and depth, bf16, random weights drawn
   on the card from a seeded generator; `make_prefill_step(cfg,
   impl="kernel")` on 4 prompts of 2048 tokens must launch
   `flash_attention` once per layer (48) and give last-position logits
   within relative L2 5e-2 of `impl="reference"`; ms per prefill,
   tokens/s and a profile;
9. llm_decode: 8 slots (max_seq 2048) fed prompts of 16..128 tokens token
   by token through `make_serve_step(cfg)` with a (B,) position vector,
   then 32 greedy tokens each; 48 `decode_attention` launches per step;
   logits held against a `decode_step(impl="reference")` run fed the same
   tokens, and one slot's logits at its last prompt token against the
   prefill path; then `decode_attention` on the run's own caches (8,
   2048, 4, 128) at the schedule's lengths against its plain version
   (bf16 and fp32) and timed there, L2-cold over all 48 layers' caches
   as phase 7 times it, which sets its `kernels` row; ms per step,
   tokens/s beside the weights' floor, and a profile;
10. ssd_scan: ptxas's spills of the bf16 kernels fail the phase; the
   kernel against its plain PyTorch version (fp32, as the op runs it on
   the CPU, cast to the input type) on the reference kernel tests' cases,
   chunks that are not powers of two and the two prefill shapes,
   mamba2-370m (4, 2048, 32, 64, n 128) and zamba2-1.2b (4, 2048, 64, 64,
   n 64), bf16, with x, B and C strided as the model hands them, within
   `_tol`; at the prefill shapes also per row against the fp32 plain
   version (FP32_ROW_REL_TOL) and timed L2-cold by events around a
   replayed CUDA graph of calls cycling SSD_TIMING_SETS input sets
   (`graph_ms`), beside back-to-back calls (`kernel_ms_eager`), the
   profiler's time and its device time per pass (the set of kernel names
   a call launches must be SSD_PASSES), the plain version and the bound
   (no PyTorch call computes the scan: no library time);
11. ssm_prefill: mamba2-370m at full width and depth, bf16, random
   weights from seed 0, `make_prefill_step` on 4 prompts of 2048 tokens:
   48 `ssd_scan` launches, logits against impl="reference" on the same
   weights in fp32 and in bf16 (SSM_LOGITS_REL_TOL), ms per prefill,
   tokens/s, a profile, and the kernel on the live scan inputs of layers
   0 and 47;
12. ssm_decode: 8 slots fed prompts of 16..128 tokens token by token at
   per-slot positions through `make_serve_step`, then 32 greedy tokens;
   no hand-written kernel runs (the Mamba2 decode step is plain PyTorch,
   checked by the launch counts); each slot's logits at its last prompt
   token against the prefill step on that prompt (SSM_LOGITS_REL_TOL);
   ms per step, tokens/s and a profile;
13. hybrid_prefill: the same for zamba2-1.2b (38 Mamba2 layers, the
   shared attention block after every 6): 38 `ssd_scan` and 6
   `flash_attention` launches per prefill;
14. hybrid_decode: the same as 12 for zamba2-1.2b, with 6
   `decode_attention` launches per step, logits held against a
   decode_step(impl="reference") run fed the same tokens, and
   `decode_attention` on the run's own shared-block caches (8, 2048, 32,
   64) against its plain version, timed over the 6 of them;
15. gossip_combine: the kernel against its plain version, bit for bit
   (`torch.equal`), on the reference kernel tests' cases, T = 65537,
   T = 0, bf16, and K = 1..6 at odd T with rows off the 16-byte grid,
   and at the ring's shape (3, 368,226,304) fp32, where it is timed
   beside the plain version, a cuBLAS GEMV (`coeffs @ weights`, a
   yardstick the port never calls) and the bound;
16. ring_gossip: `launch/fl8` on `StackedSilos(8)`, eight mamba2-370m
   replicas at full width and depth (bf16, one seeded generator per
   silo): one round per state (overlay, half, isolated) with its checks
   (8 `gossip_combine` launches a round; 2, 1 and 0 replicas per silo
   across the silo axis; fresh buffers bit-equal to the rolls; kernel
   path bit-equal to the elementwise path; overlay against
   `gossip_dense` with the ring's Metropolis matrix, within one bf16 ulp
   of sum_j |A_ij w_j|; isolated reads only the stale buffers), then
   RING_ROUNDS timed rounds per state (ms per round, bytes per round,
   the kernel's share, peak memory) and a profile of an overlay round;
17. run_fl_surface (this phase and those after it run with the
   deterministic algorithms on again; it takes no profile): the rest of
   `run_fl` for FEMNIST on gaia at full width. The 30-round run with
   `metrics=MetricsSpec()`, `trace=` and `ckpt_dir=` (every 15 rounds,
   into a temporary directory) beside the same run without them: losses
   and accuracies bit-equal, one launch a round in each, the metrics
   (30, 17) and finite with `stale_frac` and `gossip_bytes` exactly what
   the plan's strong masks give; checkpoint steps 15 and 30, their
   `sim_time_ms` the running sum of `cycle_times`, step 30's rows
   averaged and evaluated giving the last accuracy; the trace valid, with
   compile+dispatch, dispatch, eval and checkpoint host spans and the
   plan's simulated spans, whose rounds end at the running sum of
   `cycle_times`. Then `runtime="legacy"` against the flat runtime at
   momentum 0 and 0.9 (bit-equal), the "dense" aggregator against the
   kernel on the ring (bit-equal), FEMNIST on wan64 as in 4, and the
   cycle with metrics against without, in alternating turns; the wall
   time of a whole run per round (set-up included) for plain, hooked,
   hooked, plain runs, the hooked run's steady chunk from its trace, the
   checkpoint's write time and bytes;
18. run_fl_models (run last with the next phase): the same as 4 for the
   Sent140 LSTM and the iNaturalist ResNet (gaia, multigraph, batch 32,
   lr 0.05, 30 rounds), then one steady-state cycle of each, timed and
   profiled as in 5;
19. topologies: FEMNIST, 6 rounds per case, each run as in 4 (one launch
   a round, the plain aggregation bit-equal): star, mst, dmbst, ring,
   matcha and matcha_plus on gaia; the multigraph on geant, exodus and
   ebone (overlays from the blossom matching); the multigraph with
   Algorithm 1's multiplicity vector (which must train exactly as the
   default run) and another; two silos removed, randomly and by
   inefficiency.

`python3 chip_smoke.py --decode-bench DIR` instead times only the
decode kernel of the port under DIR/src at the three decode shapes
(`decode_bench`), `--ssd-bench DIR` only the SSD scan at the two
prefill shapes (`ssd_bench`), and `--cycle-bench DIR` only the FEMNIST
cycle (`cycle_bench`), so that two commits compare in one call.

Then a `{"kernels": [...]}` line, the card's name and power limit as
nvidia-smi gives them, and last `{"ok": true, "device": {...}}`. Any
failed phase prints its error and exits 1 with no result. Without a CUDA
device, or without the repository's src/ beside it, it exits non-zero.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

# cuBLAS needs a fixed workspace for deterministic results (set before
# the first CUDA call).
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
MAIN_SHAPE = dict(n=11, t=1_280_478)      # gaia silos, FEMNIST CNN size
ROUNDS = 30

# Data-sheet HBM rates (bytes/s), non-tensor fp32 peaks and dense bf16
# tensor-core peaks (flop/s).
_CARD_RATES = (("H200", 4.8e12, 67e12, 989e12),
               ("H100 NVL", 3.9e12, 60e12, 835e12),
               ("H100 PCIe", 2.0e12, 51e12, 756e12),
               ("H100", 3.35e12, 67e12, 989e12))


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def card_rates(name: str) -> tuple[float, float, str]:
    """(HBM bytes/s, fp32 flop/s, name of the row used)."""
    for key, bw, flops, _ in _CARD_RATES:
        if key in name:
            return bw, flops, key
    return 3.35e12, 67e12, "H100 SXM (assumed)"


def bf16_peak(name: str) -> float:
    """Dense bf16 tensor-core flop/s of the card."""
    for key, _, _, bf16 in _CARD_RATES:
        if key in name:
            return bf16
    return 989e12


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device(torch, ctx):
    smi = nvidia_smi_line()
    ctx["smi"] = smi
    ctx["kind"] = torch.cuda.get_device_name(0)
    ctx["count"] = torch.cuda.device_count()
    emit(phase="device", ok=True, nvidia_smi=smi, kind=ctx["kind"],
         count=ctx["count"], torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])


def phase_build(torch, ctx):
    from repro_torch.kernels import KERNELS, build
    t0 = time.perf_counter()
    libs = build.build_all(KERNELS)
    ptxas = {k: [ln for ln in build.PTXAS_LOG.get(k, "").splitlines()
                 if "registers" in ln or "spill" in ln]
             for k in KERNELS}
    emit(phase="build", ok=True, seconds=time.perf_counter() - t0,
         libraries={k: str(p.relative_to(ROOT)) for k, p in libs.items()},
         ptxas=ptxas)


def _csr_case(torch, rng, n, t, order, row_ptr, coeffs, diag, dev):
    import numpy as np
    e2 = len(order)
    w = torch.as_tensor(rng.standard_normal((n, t), dtype=np.float32),
                        device=dev)
    buf = torch.as_tensor(rng.standard_normal((e2, t), dtype=np.float32),
                          device=dev)
    return (w, buf, torch.as_tensor(coeffs[order], device=dev),
            torch.as_tensor(row_ptr, device=dev),
            torch.as_tensor(diag, device=dev))


#: The slice's other edge_aggregate shapes: (network, workload, topology,
#: T). On gaia, the LSTM and the ResNet over the multigraph (2E = 22), the
#: ResNet on MATCHA's complete base graph (2E = 110, in-degree 10, many
#: coefficients 0 in a round) and on the star (hub in-degree 10, leaves
#: 1); FEMNIST over the multigraph of the generated 64-silo WAN (N = 64,
#: 2E = 128).
EA_SHAPES = {
    "lstm_multigraph": ("gaia", "sentiment140", "multigraph", 5_070_882),
    "resnet_multigraph": ("gaia", "inaturalist", "multigraph", 11_685_170),
    "resnet_matcha": ("gaia", "inaturalist", "matcha", 11_685_170),
    "resnet_star": ("gaia", "inaturalist", "star", 11_685_170),
    "femnist_wan64": ("wan64", "femnist", "multigraph", 1_280_478)}


def _time_edge_aggregate(torch, ctx, args, dst_sorted, iters: int) -> dict:
    """The kernel on ``args`` against its plain version (bit for bit),
    timed beside the plain version, `torch.addmm` over the dense
    coefficient matrix (a yardstick the port never calls) and the bound:
    every input read once (all 2E buffer rows, zero coefficients
    included: the kernel's result depends on each) and the output
    written once, over the card's HBM rate, against its fp32 flops."""
    from repro_torch.kernels.gossip_combine import ops
    from repro_torch.kernels.gossip_combine.ref import edge_aggregate_ref
    w, buf, coeffs, rp, diag = args
    n, t = w.shape
    e2 = buf.shape[0]
    got = ops.edge_aggregate(*args)
    want = edge_aggregate_ref(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"edge_aggregate (N={n}, 2E={e2}, T={t}): "
                             f"kernel and plain version differ, max |diff| "
                             f"{err}")
    del got, want
    cmat = torch.zeros((n, e2), device=w.device)
    cmat[torch.as_tensor(dst_sorted, device=w.device).long(),
         torch.arange(e2, device=w.device)] = coeffs
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    lib_diff = float((torch.addmm(diag[:, None] * w, cmat, buf)
                      - ops.edge_aggregate(*args)).abs().max())
    kernel_ms = cuda_ms(torch, lambda: ops.edge_aggregate(*args), iters)
    plain_ms = cuda_ms(torch, lambda: edge_aggregate_ref(*args),
                       max(2, iters // 5))
    library_ms = cuda_ms(
        torch, lambda: torch.addmm(diag[:, None] * w, cmat, buf), iters)
    torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    bw, fp32, _ = card_rates(ctx["kind"])
    nbytes = (e2 + 2 * n) * t * 4 + e2 * 4 + (n + 1) * 4 + n * 4
    flops = (2 * e2 + 2 * n) * t
    bytes_ms, ops_ms = nbytes / bw * 1e3, flops / fp32 * 1e3
    return dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=library_ms, library_max_abs_diff=lib_diff,
                bytes=nbytes, flops=flops,
                achieved_gb_per_s=nbytes / kernel_ms / 1e6)


def phase_edge_aggregate(torch, ctx):
    import numpy as np
    from repro_torch.core.delay import FEMNIST, WORKLOADS
    from repro_torch.fl.dpasgd import make_round_schedule
    from repro_torch.kernels.gossip_combine import ops
    from repro_torch.kernels.gossip_combine.ref import edge_aggregate_ref
    from repro_torch.networks.registry import get_network

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    gaia = get_network("gaia")
    plan, _ = make_round_schedule("multigraph", gaia, FEMNIST)
    n, t = MAIN_SHAPE["n"], MAIN_SHAPE["t"]
    order, row_ptr = ops.csr_sort(plan.dst, n)
    main = _csr_case(torch, rng, n, t, order, row_ptr,
                     plan.coeffs[1], plan.diag[1], dev)
    # odd width, destination 0 isolated, ragged last tile
    dst = rng.integers(1, n, size=20)
    o2, rp2 = ops.csr_sort(dst, n)
    odd = _csr_case(torch, rng, n, 4099, o2, rp2,
                    rng.random(20).astype(np.float32),
                    rng.random(n).astype(np.float32), dev)
    no_edges = (odd[0], odd[1][:0], odd[2][:0],
                torch.zeros(n + 1, dtype=torch.int32, device=dev), odd[4])
    errs = {}
    for name, args in (("odd_isolated", odd), ("no_edges", no_edges)):
        got = ops.edge_aggregate(*args)
        want = edge_aggregate_ref(*args)
        torch.cuda.synchronize()
        errs[name] = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"edge_aggregate {name}: kernel and plain "
                                 f"version differ, max |diff| {errs[name]}")
    if not torch.equal(ops.edge_aggregate(*odd)[0], odd[4][0] * odd[0][0]):
        raise AssertionError("isolated destination is not diag*w")
    row = _time_edge_aggregate(torch, ctx, main, plan.dst[order], 50)
    errs["main"] = row["max_abs_err"]
    ctx["edge_aggregate"] = {k: row[k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    ctx["edge_aggregate"]["max_abs_err"] = max(errs.values())
    del main, odd, no_edges

    # The slice's other shapes, inputs drawn on the card.
    gen = torch.Generator(device=dev).manual_seed(1)
    shapes = {}
    for name, (network, wl, topology, width) in EA_SHAPES.items():
        net = get_network(network)
        n = net.num_silos
        p, _ = make_round_schedule(topology, net, WORKLOADS[wl],
                                   rounds=ROUNDS)
        o, rp = ops.csr_sort(p.dst, n)
        k = 1 % p.num_rounds_cycle
        e2 = len(p.dst)
        args = (torch.randn((n, width), generator=gen, device=dev),
                torch.randn((e2, width), generator=gen, device=dev),
                torch.as_tensor(p.coeffs[k][o], device=dev),
                torch.as_tensor(rp, device=dev),
                torch.as_tensor(p.diag[k], device=dev))
        shapes[name] = dict(
            network=network, n=n, e2=e2, t=width,
            max_in_degree=int(np.diff(rp).max()),
            nonzero_coeffs=int((p.coeffs[k] != 0).sum()),
            **_time_edge_aggregate(torch, ctx, args, p.dst[o], 20))
        del args
        torch.cuda.empty_cache()
    ctx["edge_aggregate_shapes"] = shapes
    bw, fp32, rate_key = card_rates(ctx["kind"])
    emit(phase="edge_aggregate", ok=True,
         shape=dict(n=MAIN_SHAPE["n"], e2=len(plan.dst), t=t),
         max_abs_diff=errs,
         kernel_ms=row["ms"], plain_ms=row["plain_ms"],
         library_ms=row["library_ms"],
         library_max_abs_diff=row["library_max_abs_diff"],
         bound_ms=row["bound_ms"], bytes=row["bytes"], flops=row["flops"],
         rates=dict(card=rate_key, hbm_bytes_per_s=bw, fp32_flop_per_s=fp32),
         achieved_gb_per_s=row["achieved_gb_per_s"], shapes=shapes,
         nvidia_smi=ctx["smi"])


def _deterministic(torch) -> None:
    """Deterministic algorithms for the FL runs, whose kernel and plain
    aggregation paths must agree bit for bit (warnings name any op that
    has no deterministic implementation)."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.benchmark = False


def phase_run_fl(torch, ctx):
    from repro_torch.fl import FLConfig

    _deterministic(torch)
    r = _run_twice(torch, FLConfig(dataset="femnist", network="gaia",
                                   topology="multigraph", rounds=ROUNDS,
                                   eval_every=15))
    ctx["launches"]["edge_aggregate"] = r["launches"]
    emit(phase="run_fl", ok=True, reference_aggregator_equal=True, **r)


def _cycle_timing(torch, dataset: str, aggregators, profile=True) -> dict:
    """One steady-state multigraph cycle of ``dataset``'s model on gaia
    at batch 32 and `run_fl`'s precision (`pin_fp32`: no TF32 in cuDNN
    or cuBLAS), timed per aggregator in the given turns ("kernel",
    "reference", or "kernel+metrics": the kernel with `MetricsSpec()`),
    and, with ``profile``, a profile of where its device time goes:
    kernel time by name, and the device's idle share against the
    unprofiled cycle time. A profile that sees no device time fails the
    caller's phase."""
    import numpy as np
    from repro_torch.core.delay import WORKLOADS
    from repro_torch.data.synthetic import make_federated_dataset
    from repro_torch.device import pin_fp32
    from repro_torch.fl import flat as flatmod, runtime as flrt
    from repro_torch.fl.dpasgd import make_round_schedule
    from repro_torch.fl.trainer import _DATASET_MODEL, _DATASET_WL
    from repro_torch.models.small import SMALL_MODELS
    from repro_torch.networks.registry import get_network
    from repro_torch.obs import MetricsSpec
    from repro_torch.optim import flat_sgd

    dev = torch.device("cuda")
    pin_fp32(dev)
    net = get_network("gaia")
    n = net.num_silos
    spec = SMALL_MODELS[_DATASET_MODEL[dataset]]
    plan, _ = make_round_schedule("multigraph", net,
                                  WORKLOADS[_DATASET_WL[dataset]])
    params = spec.init(torch.Generator().manual_seed(0))
    rt = flrt.make_flat_runtime(plan, params, n)
    opt = flat_sgd(0.05)
    data = make_federated_dataset(dataset, n, samples_per_silo=128)
    rng = np.random.default_rng(1)
    r = rt.num_rounds_cycle
    per = [[data.sample_batch(s, 32, rng) for s in range(n)]
           for _ in range(r)]
    batches = {
        "x": torch.as_tensor(np.stack([[np.stack([b["x"] for b in p])]
                                       for p in per]), device=dev),
        "y": torch.as_tensor(np.stack([[np.stack([b["y"] for b in p])]
                                       for p in per]), device=dev).long()}
    plan_t = [torch.as_tensor(getattr(rt, k), device=dev)
              for k in ("strong", "coeffs", "diag")]
    w0 = flatmod.ravel(rt.spec, params).to(dev)
    times = {}
    for turn in aggregators:
        agg, _, metrics = turn.partition("+")
        cycle = flrt.make_cycle_fn(rt, loss_fn=spec.loss, opt=opt,
                                   aggregator=agg,
                                   metrics=MetricsSpec() if metrics else None)
        state = flrt.init_flat_state(w0, opt, rt)
        times.setdefault(turn, []).append(cuda_ms(
            torch, lambda: cycle(state, batches, *plan_t), 5, warmup=1))
    if not profile:
        return dict(rounds=r, batch_size=32, t=rt.spec.size, cycle_ms=times,
                    round_ms={k: [x / r for x in v]
                              for k, v in times.items()})
    cycle = flrt.make_cycle_fn(rt, loss_fn=spec.loss, opt=opt)
    state = flrt.init_flat_state(w0, opt, rt)
    cycle(state, batches, *plan_t)
    torch.cuda.synchronize()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        cycle(state, batches, *plan_t)
        torch.cuda.synchronize()
    # kernels only: op-level rows repeat their kernels' device time
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA
                   and ev.self_device_time_total > 0), reverse=True)
    busy_ms = sum(x[0] for x in rows) / 1e3
    if busy_ms == 0:
        raise RuntimeError(f"{dataset}: the profiler saw no device time")
    cycle_ms = min(times["kernel"])
    profile = dict(
        device_busy_ms=busy_ms, kernel_launches=sum(x[2] for x in rows),
        edge_aggregate_ms=sum(us for us, k, _ in rows
                              if "edge_aggregate" in k) / 1e3,
        idle_share=max(0.0, 1 - busy_ms / cycle_ms),
        top=[dict(kernel=k[:100], device_ms=us / 1e3, calls=c)
             for us, k, c in rows[:12]])
    return dict(rounds=r, batch_size=32, t=rt.spec.size, cycle_ms=times,
                round_ms={k: [x / r for x in v] for k, v in times.items()},
                profile=profile)


def phase_cycle(torch, ctx):
    """Steady-state FEMNIST cycle time per aggregator, and a device-time
    profile of one cycle (sums by kernel name)."""
    emit(phase="cycle", ok=True, **_cycle_timing(
        torch, "femnist", ("kernel", "reference", "kernel", "reference")))


def _timed_run(torch, cfg, **kw):
    """`train(cfg, **kw)` on the card with the launch count zeroed just
    before: (result, wall seconds, edge_aggregate launches)."""
    from repro_torch.fl import train
    from repro_torch.kernels.gossip_combine import ops

    ops.edge_aggregate.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = train(cfg, **kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, ops.edge_aggregate.launches


def _run_twice(torch, cfg) -> dict:
    """`train(cfg)` on the card with the launch count zeroed just before
    and read just after (`_timed_run`), then
    `train(cfg, aggregator="reference")`; the
    kernel must launch once per round, the losses must be finite and the
    two runs equal bit for bit. Warnings that PyTorch raises for an op
    without a deterministic implementation are returned, not hidden."""
    import warnings
    from repro_torch.fl import train

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res, wall, launches = _timed_run(torch, cfg)
        t0 = time.perf_counter()
        ref = train(cfg, device="cuda", aggregator="reference")
        torch.cuda.synchronize()
        wall_ref = time.perf_counter() - t0
    nondet = sorted({str(w.message)[:160] for w in caught
                     if "deterministic" in str(w.message)})
    what = f"{cfg.dataset}/{cfg.network}/{cfg.topology}"
    if launches != cfg.rounds:
        raise AssertionError(f"{what}: edge_aggregate launched {launches} "
                             f"times in {cfg.rounds} rounds")
    if not all(math.isfinite(x) for x in res.round_losses):
        raise AssertionError(f"{what}: non-finite losses {res.round_losses}")
    if ref.round_losses != res.round_losses or ref.eval_accs != res.eval_accs:
        raise AssertionError(
            f"{what}: kernel and plain aggregation diverged: "
            f"{res.round_losses} vs {ref.round_losses}; ops without a "
            f"deterministic implementation: {nondet}")
    return dict(rounds=cfg.rounds, launches=launches, wall_s=wall,
                ms_per_round=wall / cfg.rounds * 1e3,
                wall_s_reference_aggregator=wall_ref,
                mean_cycle_ms=res.mean_cycle_ms,
                total_time_s=res.total_time_s, round_losses=res.round_losses,
                eval_rounds=res.eval_rounds, eval_accs=res.eval_accs,
                nondeterministic_warnings=nondet)


#: run_fl_surface: evals and checkpoints every SURFACE_EVERY rounds of the
#: ROUNDS-round FEMNIST run; the dense and wan64 cases run TOPO_ROUNDS.
SURFACE_EVERY = 15


def _surface_hooks(torch, tmp: Path) -> dict:
    """The FEMNIST run with metrics=, trace= and ckpt_dir= beside the same
    run without them: bit-equal losses and accuracies, one launch a round
    in each, the metrics' count columns from the plan's strong masks, the
    checkpoints' rows and meta, the trace's spans against the plan."""
    import numpy as np
    from repro_torch.checkpoint import CheckpointManager, load_fl_checkpoint
    from repro_torch.core.delay import FEMNIST
    from repro_torch.data.synthetic import make_federated_dataset
    from repro_torch.fl import FLConfig, dpasgd, flat as flatmod
    from repro_torch.models.small import FEMNIST_CNN
    from repro_torch.networks.registry import get_network
    from repro_torch.obs import (MetricsSpec, TraceRecorder, to_trace_json,
                                 validate_trace)

    kw = dict(dataset="femnist", network="gaia", topology="multigraph",
              rounds=ROUNDS, eval_every=SURFACE_EVERY)
    # plain, hooked, hooked, plain: each kind runs once first and once
    # after the other, so the wall times of the two kinds see the same
    # order effects; the checks read the second hooked run's files
    runs = {"plain": [], "hooked": []}
    for i, kind in enumerate(("plain", "hooked", "hooked", "plain")):
        trace, ckpt_dir = tmp / f"trace{i}.json", tmp / f"ckpt{i}"
        hooks = {} if kind == "plain" else dict(
            metrics=MetricsSpec(), trace=str(trace), ckpt_dir=str(ckpt_dir),
            ckpt_every=SURFACE_EVERY)
        res, wall, launches = _timed_run(torch, FLConfig(**kw, **hooks))
        if launches != ROUNDS:
            raise AssertionError(f"{kind} run {i}: edge_aggregate launched "
                                 f"{launches} times in {ROUNDS} rounds")
        runs[kind].append((res, wall, trace, ckpt_dir))
    plain, hooked = runs["plain"][0][0], runs["hooked"][1][0]
    trace, ckpt_dir = runs["hooked"][1][2:]
    for res, *_ in runs["plain"] + runs["hooked"]:
        if (res.round_losses != plain.round_losses
                or res.eval_accs != plain.eval_accs):
            raise AssertionError(
                f"the hooks changed the run: losses {res.round_losses} vs "
                f"{plain.round_losses}, accuracies {res.eval_accs} vs "
                f"{plain.eval_accs}")
    if not all(math.isfinite(x) for x in plain.round_losses):
        raise AssertionError(f"non-finite losses {plain.round_losses}")

    # metrics: (ROUNDS, 17), finite; count columns from the strong masks
    mets, cols = hooked.metrics, hooked.metric_columns
    if mets.shape != (ROUNDS, 17) or not np.isfinite(mets).all():
        raise AssertionError(f"metrics {mets.shape}, finite "
                             f"{np.isfinite(mets).all()}")
    plan, tplan = dpasgd.make_round_schedule("multigraph",
                                             get_network("gaia"), FEMNIST,
                                             rounds=ROUNDS)
    strong = plan.strong[np.arange(ROUNDS) % plan.num_rounds_cycle]
    n_strong = strong.sum(axis=1).astype(np.float32)
    t = MAIN_SHAPE["t"]
    want = {"stale_frac": np.float32(1) - n_strong
            / np.float32(strong.shape[1]),
            "gossip_bytes": n_strong * np.float32(t * 4)}
    for name, value in want.items():
        got = mets[:, cols.index(name)]
        if not np.array_equal(got, value):
            raise AssertionError(f"{name} {got.tolist()} is not what the "
                                 f"strong masks give, {value.tolist()}")

    # checkpoints: steps, sim_time_ms, the last rows evaluated
    cum = np.cumsum(hooked.cycle_times_ms)
    steps = CheckpointManager(ckpt_dir).steps()
    if steps != [SURFACE_EVERY, ROUNDS]:
        raise AssertionError(f"checkpoint steps {steps}")
    for step in steps:
        meta = load_fl_checkpoint(ckpt_dir, step).meta
        if meta["sim_time_ms"] != cum[step - 1] or meta["round"] != step:
            raise AssertionError(f"step {step}: sim_time_ms "
                                 f"{meta['sim_time_ms']} vs {cum[step - 1]}")
    last = load_fl_checkpoint(ckpt_dir, ROUNDS)
    ckpt_bytes = (ckpt_dir / f"step_{ROUNDS}.msgpack").stat().st_size
    data = make_federated_dataset("femnist", 11, samples_per_silo=128)
    test = {"x": torch.as_tensor(data.test_x, device="cuda"),
            "y": torch.as_tensor(data.test_y, dtype=torch.long,
                                 device="cuda")}
    spec = flatmod.make_flat_spec(FEMNIST_CNN.init(torch.Generator()))
    rows = torch.as_tensor(last.w.copy(), device="cuda")
    with torch.no_grad():
        acc = float(FEMNIST_CNN.accuracy(
            flatmod.unravel(spec, rows.mean(dim=0)), test))
    if last.w.shape != (11, t) or acc != hooked.eval_accs[-1]:
        raise AssertionError(f"step {ROUNDS}'s rows {last.w.shape} evaluate "
                             f"to {acc}, the run to {hooked.eval_accs[-1]}")

    # trace: valid, host spans, sim spans equal to the plan's, which end
    # each round at the running sum of cycle_times
    obj = json.loads(trace.read_text())
    errs = validate_trace(obj)
    if errs:
        raise AssertionError(f"invalid trace: {errs[:5]}")
    host = [e for e in obj["traceEvents"] if e.get("cat") == "host"]
    names = {e["name"] for e in host}
    if not {"compile+dispatch", "dispatch", "eval", "checkpoint"} <= names:
        raise AssertionError(f"host spans {sorted(names)}")
    rec = TraceRecorder()
    rec.add_sim_spans(tplan, ROUNDS)

    def sim(o):
        return [e for e in o["traceEvents"] if e.get("cat") == "sim"]

    if sim(obj) != sim(to_trace_json(rec)):
        raise AssertionError("the run's simulated spans are not the plan's")
    ends = [rec.round_end_ms(k) for k in range(ROUNDS)]
    if ends != cum.tolist():
        raise AssertionError(f"round ends {ends} vs cumsum(cycle_times) "
                             f"{cum.tolist()}")
    counters = {e["name"] for e in obj["traceEvents"] if e["ph"] == "C"}
    if counters != set(cols):
        raise AssertionError(f"counters {sorted(counters)}")
    ckpt_ms = [e["dur"] / 1e3 for e in host if e["name"] == "checkpoint"]
    # ms a round = a whole train() over ROUNDS, so dataset, sampling,
    # evals and the first chunk are in it; "dispatch" = the hooked run's
    # steady chunks alone, from its trace
    dispatch_ms = [e["dur"] / 1e3 for e in host if e["name"] == "dispatch"]
    return dict(
        launches=ROUNDS, run_order=["plain", "hooked", "hooked", "plain"],
        ms_per_round_with_setup={
            kind: [wall / ROUNDS * 1e3 for _, wall, *_ in rs]
            for kind, rs in runs.items()},
        dispatch_chunk_ms=dispatch_ms,
        checkpoint_write_ms=ckpt_ms, checkpoint_bytes=ckpt_bytes,
        row_bytes=11 * t * 4, metric_columns=list(cols),
        metrics_last_round=mets[-1].tolist(),
        host_spans={n: len([e for e in host if e["name"] == n])
                    for n in sorted(names)},
        round_losses=plain.round_losses, eval_accs=plain.eval_accs)


def _legacy_vs_flat(torch) -> dict:
    """`runtime="legacy"` against the flat runtime on the FEMNIST config,
    at momentum 0 and 0.9: losses and accuracies bit-equal (the vmapped
    convolutions copy the flat runtime's weight views into contiguous
    tensors, so cuDNN sees the legacy runtime's layouts)."""
    from repro_torch.fl import FLConfig

    out = {}
    for momentum in (0.0, 0.9):
        kw = dict(dataset="femnist", network="gaia", topology="multigraph",
                  rounds=ROUNDS, eval_every=SURFACE_EVERY, momentum=momentum)
        flat, flat_s, _ = _timed_run(torch, FLConfig(**kw))
        legacy, legacy_s, launches = _timed_run(
            torch, FLConfig(runtime="legacy", **kw))
        a, b = flat.round_losses, legacy.round_losses
        out[f"momentum_{momentum}"] = dict(
            max_abs_loss_diff=max(abs(x - y) for x, y in zip(a, b)),
            legacy_launches=launches, eval_accs=legacy.eval_accs,
            ms_per_round=[flat_s / ROUNDS * 1e3, legacy_s / ROUNDS * 1e3])
        if launches != 0:
            raise AssertionError(f"the legacy runtime launched "
                                 f"edge_aggregate {launches} times")
        if a != b or flat.eval_accs != legacy.eval_accs:
            raise AssertionError(
                f"legacy vs flat at momentum {momentum}: losses {b} vs {a}, "
                f"accuracies {legacy.eval_accs} vs {flat.eval_accs}")
    return out


def phase_run_fl_surface(torch, ctx):
    """The rest of `run_fl` on the card, FEMNIST at full width (batch 32,
    `pin_fp32`): the hooks (`_surface_hooks`), legacy against flat
    (`_legacy_vs_flat`), the dense aggregator on the ring, and wan64
    through `_run_twice`; then the cycle with metrics against without, in
    alternating turns. No profile; files go to a temporary directory."""
    import tempfile
    from repro_torch.fl import FLConfig

    _deterministic(torch)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        hooks = _surface_hooks(torch, Path(tmp))
    legacy = _legacy_vs_flat(torch)
    ring = FLConfig(dataset="femnist", network="gaia", topology="ring",
                    rounds=TOPO_ROUNDS, eval_every=TOPO_ROUNDS)
    dense, _, _ = _timed_run(torch, ring, aggregator="dense")
    kernel, _, launches = _timed_run(torch, ring)
    if (dense.round_losses != kernel.round_losses
            or dense.eval_accs != kernel.eval_accs or launches != TOPO_ROUNDS):
        raise AssertionError(f"dense vs kernel on the ring: "
                             f"{dense.round_losses} vs {kernel.round_losses}, "
                             f"{launches} launches")
    torch.cuda.empty_cache()
    wan64 = _run_twice(torch, FLConfig(dataset="femnist", network="wan64",
                                       topology="multigraph",
                                       rounds=TOPO_ROUNDS,
                                       eval_every=TOPO_ROUNDS))
    ctx["launches"]["edge_aggregate_wan64"] = wan64["launches"]
    torch.cuda.empty_cache()
    cycle = _cycle_timing(torch, "femnist", ("kernel", "kernel+metrics") * 2,
                          profile=False)
    emit(phase="run_fl_surface", ok=True, seconds=time.perf_counter() - t0,
         nvidia_smi=ctx["smi"], hooks=hooks, legacy_vs_flat=legacy,
         dense_vs_kernel=dict(bit_equal=True, launches=launches,
                              losses=dense.round_losses),
         wan64={k: wan64[k] for k in (
             "launches", "wall_s", "ms_per_round", "mean_cycle_ms",
             "total_time_s", "round_losses", "nondeterministic_warnings")},
         cycle_metrics=cycle)


def phase_run_fl_models(torch, ctx):
    """`run_fl` for the Sent140 LSTM and the iNaturalist ResNet on gaia
    over the multigraph, at full width with the paper's defaults (batch
    32, lr 0.05), ROUNDS rounds, each run twice (`_run_twice`); then one
    steady-state cycle of each, timed and profiled (`_cycle_timing`).
    Runs after every other phase: its profile of a Sent140 cycle (74,000
    kernels) left the profiler blind to the decode kernel's later ones."""
    from repro_torch.fl import FLConfig

    _deterministic(torch)
    torch.cuda.empty_cache()
    out = {}
    for dataset in ("sent140", "inat"):
        cfg = FLConfig(dataset=dataset, network="gaia",
                       topology="multigraph", rounds=ROUNDS, eval_every=15)
        out[dataset] = _run_twice(torch, cfg)
        out[dataset]["cycle"] = _cycle_timing(torch, dataset, ("kernel",))
        torch.cuda.empty_cache()
    emit(phase="run_fl_models", ok=True, nvidia_smi=ctx["smi"], **out)


#: The topologies phase: FEMNIST, TOPO_ROUNDS rounds, one run_fl per case.
TOPO_ROUNDS = 6


def _topology_cases():
    from repro_torch.core.delay import FEMNIST
    from repro_torch.core.multigraph import build_multigraph
    from repro_torch.design.catalog import ring_topology
    from repro_torch.networks.registry import get_network

    gaia = get_network("gaia")
    overlay = ring_topology(gaia, FEMNIST).graph
    mg = build_multigraph(gaia, FEMNIST, overlay)
    alg1 = tuple(mg.multiplicity[p] for p in overlay.pairs)
    cases = {t: dict(topology=t) for t in
             ("star", "mst", "dmbst", "ring", "matcha", "matcha_plus")}
    for net in ("geant", "exodus", "ebone"):
        cases[f"multigraph/{net}"] = dict(network=net)
    cases["multiplicity/algorithm1"] = dict(multiplicity=alg1)
    cases["multiplicity/other"] = dict(
        multiplicity=tuple(1 + i % 3 for i in range(len(alg1))))
    for strategy in ("random", "inefficient"):
        cases[f"remove_silos/{strategy}"] = dict(remove_silos=2,
                                                 remove_strategy=strategy)
    return cases


def phase_topologies(torch, ctx):
    """FEMNIST under every other Table-1 topology on gaia, the multigraph
    on geant, exodus and ebone (blossom overlays), explicit
    multiplicities (Algorithm 1's vector, which must train as the
    default run, and another) and two silos removed under both
    strategies: each case through `_run_twice`."""
    from repro_torch.fl import FLConfig

    _deterministic(torch)
    out = {}
    t0 = time.perf_counter()
    for name, change in _topology_cases().items():
        cfg = FLConfig(dataset="femnist", rounds=TOPO_ROUNDS,
                       eval_every=TOPO_ROUNDS, **change)
        r = _run_twice(torch, cfg)
        out[name] = {k: r[k] for k in (
            "launches", "wall_s", "ms_per_round", "mean_cycle_ms",
            "total_time_s", "nondeterministic_warnings")}
        out[name]["losses"] = r["round_losses"]
    default = _run_twice(torch, FLConfig(dataset="femnist",
                                         rounds=TOPO_ROUNDS,
                                         eval_every=TOPO_ROUNDS))
    if out["multiplicity/algorithm1"]["losses"] != default["round_losses"]:
        raise AssertionError("Algorithm 1's multiplicity vector does not "
                             "train as the default run")
    emit(phase="topologies", ok=True, rounds=TOPO_ROUNDS,
         seconds=time.perf_counter() - t0, nvidia_smi=ctx["smi"], cases=out)


# flash_attention cases of the reference's kernel tests: (b, hq, hkv, s,
# hd, window, prefix, dtype), and one with whole key tiles masked for
# some rows (window 8 over 32-key tiles), where the running max stays at
# -inf until a later tile (the `safe` guard).
FA_CASES = [
    (2, 4, 2, 64, 32, 0, 0, "float32"),
    (1, 8, 1, 128, 64, 0, 0, "float32"),      # MQA
    (1, 8, 8, 96, 32, 0, 0, "float32"),       # MHA, ragged blocks
    (2, 4, 4, 96, 32, 16, 0, "float32"),      # sliding window
    (1, 2, 1, 64, 32, 0, 24, "float32"),      # bidirectional prefix
    (1, 4, 2, 64, 32, 8, 16, "float32"),      # window + prefix
    (2, 4, 2, 64, 64, 0, 0, "bfloat16"),      # bf16
    (1, 16, 4, 80, 128, 0, 0, "float32"),     # hd=128, non-multiple seq
    (1, 1, 1, 256, 64, 8, 0, "float32"),      # rows masked over whole tiles
    # bf16 on the tensor-core route: masks, odd groups, ragged tiles
    (1, 4, 2, 200, 128, 16, 40, "bfloat16"),  # window + prefix, hd=128
    (2, 6, 2, 80, 64, 0, 0, "bfloat16"),      # group of 3
    (1, 8, 1, 130, 32, 0, 0, "bfloat16"),     # MQA, hd=32
    (1, 1, 1, 256, 128, 8, 0, "bfloat16"),    # rows masked over whole tiles
    (4, 32, 32, 2048, 64, 0, 0, "bfloat16"),  # zamba2's shared block
    # what the wgmma route does differently
    (1, 14, 2, 300, 128, 0, 0, "bfloat16"),   # G=7 (qwen2-7b): 126 rows
    (1, 8, 1, 40, 64, 0, 0, "bfloat16"),      # S under one key tile
    (2, 8, 1, 333, 64, 0, 0, "bfloat16"),     # ragged 128-key tiles
    (1, 4, 2, 520, 128, 200, 130, "bfloat16"),  # window/prefix across tiles
]
#: q, k, v as column slices of one fused (B, S, (Hq + 2 Hkv) hd)
#: projection, so q's sequence stride is not Hq hd.
FA_FUSED = (2, 28, 4, 300, 128, 0, 0, "bfloat16")
FA_MAIN = (4, 32, 4, 2048, 128, 0, 0, "bfloat16")   # yi-9b prefill
FA_ZAMBA2 = (4, 32, 32, 2048, 64, 0, 0, "bfloat16")  # zamba2-1.2b prefill
# decode_attention cases: (b, hq, hkv, s, hd, dtype)
DEC_CASES = [
    (2, 4, 2, 128, 32, "float32"),
    (1, 8, 1, 256, 64, "float32"),    # MQA
    (2, 16, 4, 200, 128, "float32"),  # ragged blocks
    (1, 4, 4, 96, 32, "bfloat16"),    # MHA bf16
    (8, 32, 32, 2048, 64, "bfloat16"),  # zamba2's shared block, 8 slots
    # the configs' groups: 2 (gemma3), 5 (qwen2.5-14b), 7 (qwen2-7b); MQA
    # with 32 heads (4 n8 tiles); 40 heads (a second CTA on grid z); hd 256
    (2, 4, 2, 300, 128, "bfloat16"),
    (2, 10, 2, 333, 128, "bfloat16"),
    (1, 28, 4, 700, 128, "bfloat16"),
    (2, 32, 1, 520, 64, "bfloat16"),
    (1, 40, 1, 260, 32, "bfloat16"),
    (2, 8, 2, 300, 256, "bfloat16"),
]
DEC_MAIN = (8, 32, 4, 4096, 128, "bfloat16")        # yi-9b decode, 8 slots


def _tol(dtype: str) -> dict:
    """The reference kernel tests' tolerances (test_kernels._tol)."""
    return (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
            else dict(rtol=5e-4, atol=5e-4))


def _compare(torch, got, want, dtype: str, what: str) -> float:
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    tol = _tol(dtype)
    bad = (got - want).abs() > tol["atol"] + tol["rtol"] * want.abs()
    if not torch.isfinite(got).all() or bool(bad.any()):
        raise AssertionError(f"{what}: kernel and plain version differ, max "
                             f"|diff| {err} (rtol=atol={tol['atol']})")
    return err


#: Largest per-row relative L2 distance (a row: one query's hd outputs,
#: or one (token, head)'s p outputs of the SSD scan) allowed between a
#: bf16 kernel's output and its plain version run in fp32 on the same
#: bf16 inputs, at the main path's shapes: about three times the largest
#: reading on an H100 (0.0032, 0.0020 and 0.0033, PERF.md). Dropping one
#: key tile of a row of n keys moves it by about sqrt(tile / n): 0.18 for
#: 64 of 2,048; the bf16 output's own rounding alone gives about 0.002.
FP32_ROW_REL_TOL = {"flash_attention": 1e-2, "decode_attention": 6e-3,
                    "ssd_scan": 1e-2}


def _hold_fp32(torch, got, want32, kernel: str, what: str) -> dict:
    """bf16 kernel output against the plain version in fp32: the overall
    relative L2 distance and the largest per-row one."""
    got, want32 = got.float(), want32.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    diff = (got - want32).norm(dim=-1)
    row = float((diff / want32.norm(dim=-1).clamp_min(1e-30)).max())
    rel = float((got - want32).norm() / want32.norm())
    if row > FP32_ROW_REL_TOL[kernel]:
        raise AssertionError(f"{what}: kernel vs fp32 plain version, row "
                             f"relative L2 {row} > {FP32_ROW_REL_TOL[kernel]}")
    return dict(rel_l2=rel, row_rel_l2_max=row)


def device_ms(torch, fn, iters: int, warmup: int = 3, name=None) -> float:
    """Device time per call under the profiler: all kernels' time, or only
    those whose name contains ``name``. For calls too short to time with
    events: back to back they would measure the host's launch rate."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(3):  # now and then a profile comes back without kernels
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [ev for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA]
        us = sum(ev.self_device_time_total for ev in kernels
                 if name is None or name in ev.key)
        if us > 0:
            return us / 1e3 / iters
        seen.append(len(kernels))
    raise RuntimeError(f"the profiler saw no device time for {name!r} in "
                       f"three profiles (device events per profile: {seen})")


def _fa_inputs(torch, case, gen, fused=False):
    b, hq, hkv, s, hd, _, _, dt = case
    dtype = getattr(torch, dt)
    if fused:
        qkv = torch.randn((b, s, (hq + 2 * hkv) * hd), generator=gen,
                          device="cuda", dtype=torch.float32).to(dtype)
        return [x.unflatten(-1, (-1, hd)) for x in
                qkv.split((hq * hd, hkv * hd, hkv * hd), dim=-1)]
    return [torch.randn((b, s, h, hd), generator=gen, device="cuda",
                        dtype=torch.float32).to(dtype)
            for h in (hq, hkv, hkv)]


def _fa_want_route(case) -> str:
    """The kernel's route rule for contiguous inputs of group <= 128."""
    return ("wgmma" if case[7] == "bfloat16" and case[4] in (64, 128)
            else "cuda_core")


def ptxas_functions(log: str) -> dict:
    """Registers and spill bytes of each kernel in an `nvcc -Xptxas=-v`
    log, by mangled name."""
    import re
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            out[name].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def _fa_sdpa(torch, q, k, v):
    import torch.nn.functional as F
    return lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, enable_gqa=q.shape[2] != k.shape[2])


def _fa_bound(ctx, case) -> dict:
    """Causal work and bytes of one call at ``case``, and the least time
    the card could take for it."""
    b, hq, hkv, s, hd = case[:5]
    flops = 4 * b * hq * hd * (s * (s + 1) // 2)  # causal (qpos, kpos) pairs
    nbytes = 2 * (2 * b * s * hq * hd + 2 * b * s * hkv * hd)
    bw, _, rate_key = card_rates(ctx["kind"])
    peak = bf16_peak(ctx["kind"])
    bytes_ms, ops_ms = nbytes / bw * 1e3, flops / peak * 1e3
    return dict(flops=flops, bytes=nbytes, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                rates=dict(card=rate_key, hbm_bytes_per_s=bw,
                           bf16_flop_per_s=peak))


def phase_flash_attention(torch, ctx):
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    def plain(q, k, v, window=0, prefix=0):
        return flash_attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            window=window, prefix=prefix).transpose(1, 2)

    # The FL phases pin deterministic algorithms, under which torch fills
    # every new tensor and index_put checks its indices on the card; the
    # serving phases run as a server would, without them.
    torch.use_deterministic_algorithms(False)
    ptxas = {k: v for k, v in ptxas_functions(
        build.PTXAS_LOG.get("flash_attention", "")).items() if "wgmma" in k}
    spills = {k: v for k, v in ptxas.items()
              if v.get("spill_stores") or v.get("spill_loads")}
    if spills:
        raise AssertionError(f"flash_attention: the wgmma kernels spill: "
                             f"{spills}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs, routes = {}, {}
    for case, fused in ([(c, False) for c in FA_CASES + [FA_MAIN]]
                        + [(FA_FUSED, True)]):
        q, k, v = _fa_inputs(torch, case, gen, fused)
        win, pre, dt = case[5], case[6], case[7]
        what = f"flash_attention {case}{' fused' if fused else ''}"
        routes[what] = ops.route(q, k, v)
        if routes[what] != _fa_want_route(case):
            raise AssertionError(f"{what}: route {routes[what]}, expected "
                                 f"{_fa_want_route(case)}")
        got = ops.flash_attention(q, k, v, window=win, prefix=pre)
        torch.cuda.synchronize()
        errs[what] = _compare(torch, got, plain(q, k, v, win, pre), dt, what)
        if case != FA_MAIN:
            del got
        else:
            main = (q, k, v, got)
    q, k, v, got = main
    fp32 = _hold_fp32(torch, got, plain(q.float(), k.float(), v.float()),
                      "flash_attention", f"flash_attention {FA_MAIN}")
    del got, main
    kernel_ms = cuda_ms(torch, lambda: ops.flash_attention(q, k, v), 20)
    plain_ms = cuda_ms(torch, lambda: plain(q, k, v), 3, warmup=1)
    sdpa = _fa_sdpa(torch, q, k, v)
    library_ms = cuda_ms(torch, sdpa, 20)
    lib_err = float((sdpa().transpose(1, 2).float()
                     - ops.flash_attention(q, k, v).float()).abs().max())
    bound = _fa_bound(ctx, FA_MAIN)
    ctx["flash_attention"] = dict(
        max_abs_err=max(errs.values()), ms=kernel_ms, plain_ms=plain_ms,
        bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
        library_ms=library_ms)
    # zamba2-1.2b's shared attention block: timed beside SDPA and its bound
    qz, kz, vz = _fa_inputs(torch, FA_ZAMBA2, gen)
    zamba2 = dict(
        route=ops.route(qz, kz, vz),
        kernel_ms=cuda_ms(torch, lambda: ops.flash_attention(qz, kz, vz), 20),
        plain_ms=cuda_ms(torch, lambda: plain(qz, kz, vz), 3, warmup=1),
        library_ms=cuda_ms(torch, _fa_sdpa(torch, qz, kz, vz), 20),
        **_fa_bound(ctx, FA_ZAMBA2))
    zamba2["achieved_tflop_per_s"] = (zamba2["flops"] / zamba2["kernel_ms"]
                                      / 1e9)
    del qz, kz, vz
    b, hq, hkv, s, hd = FA_MAIN[:5]
    emit(phase="flash_attention", ok=True,
         shape=dict(b=b, s=s, hq=hq, hkv=hkv, hd=hd, dtype="bfloat16",
                    causal=True), route=ops.route(q, k, v), routes=routes,
         wgmma_ptxas=ptxas,
         max_abs_diff=errs, vs_fp32_plain=fp32, kernel_ms=kernel_ms,
         plain_ms=plain_ms, library_ms=library_ms,
         library_max_abs_diff=lib_err, fp32_row_rel_tol=FP32_ROW_REL_TOL[
             "flash_attention"],
         achieved_tflop_per_s=bound["flops"] / kernel_ms / 1e9, **bound,
         zamba2=dict(shape=list(FA_ZAMBA2[:5]), **zamba2))


def _dec_caches(torch, case, gen):
    b, hq, hkv, s, hd, dt = case
    return tuple(torch.randn((b, s, hkv, hd), generator=gen, device="cuda")
                 .to(getattr(torch, dt)) for _ in range(2))


def _dec_inputs(torch, case, gen):
    b, hq, hkv, s, hd, dt = case
    q = torch.randn((b, hq, hd), generator=gen, device="cuda").to(
        getattr(torch, dt))
    k, v = _dec_caches(torch, case, gen)
    lengths = torch.randint(1, s + 1, (b,), generator=gen, device="cuda",
                            dtype=torch.int32)
    return q, k, v, lengths


def _dec_plain(q, k, v, lengths):
    """The decode kernel's plain version on the transformer's cache
    layout (B, S, Hkv, hd)."""
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    return decode_attention_ref(q, k.transpose(1, 2), v.transpose(1, 2),
                                lengths)


def phase_decode_attention(torch, ctx):
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import ops

    ptxas = ptxas_functions(build.PTXAS_LOG.get("decode_attention", ""))
    spills = {k: v for k, v in ptxas.items()
              if v.get("spill_stores") or v.get("spill_loads")}
    if spills:
        raise AssertionError(f"decode_attention: the kernels spill: {spills}")
    gen = torch.Generator(device="cuda").manual_seed(1)
    errs = {}
    for case in DEC_CASES + [DEC_MAIN]:
        q, k, v, lengths = _dec_inputs(torch, case, gen)
        got = ops.decode_attention(q, k, v, lengths)
        torch.cuda.synchronize()
        errs[str(case)] = _compare(torch, got, _dec_plain(q, k, v, lengths),
                                   case[-1], f"decode_attention {case}")
        # cache rows at or past lengths[b] are never read
        pos = torch.arange(k.shape[1], device="cuda")[None, :, None, None]
        past = pos >= lengths.long()[:, None, None, None]
        k2 = torch.where(past, float("nan"), k)
        v2 = torch.where(past, float("nan"), v)
        if not torch.equal(ops.decode_attention(q, k2, v2, lengths), got):
            raise AssertionError(f"decode_attention {case}: rows past "
                                 "lengths changed the output")
    # q, k, v, lengths, got are DEC_MAIN's
    fp32 = _hold_fp32(torch, got, _dec_plain(q.float(), k.float(),
                                             v.float(), lengths),
                      "decode_attention", f"decode_attention {DEC_MAIN}")
    ctx["decode_attention_errs"] = errs
    sets = [(q, k, v)] + [(q, *_dec_caches(torch, DEC_MAIN, gen))
                          for _ in range(DEC_MAIN_COPIES - 1)]
    timing = _decode_timing(torch, ctx, sets, lengths.cpu())
    emit(phase="decode_attention", ok=True, ptxas=ptxas, max_abs_diff=errs,
         vs_fp32_plain=fp32,
         fp32_row_rel_tol=FP32_ROW_REL_TOL["decode_attention"], **timing)


#: calls per CUDA graph in the L2-cold timing (at least one per cache set)
GRAPH_CALLS = 24
#: copies of DEC_MAIN's caches cycled by its timing: at its random lengths
#: their visible rows (18-40 MB a copy) exceed the 50 MB L2
DEC_MAIN_COPIES = 4


def graph_ms(torch, calls, replays: int = 5) -> float:
    """Device ms per call of ``calls`` (argument-less callables, each on
    its own inputs), cycled to at least GRAPH_CALLS calls, captured in one
    CUDA graph and replayed between CUDA events. The host's launch rate
    does not enter the time, and when the calls' inputs together exceed
    the L2 cache each call finds its own inputs cold, as a decode step
    finds each layer's cache."""
    seq = [calls[i % len(calls)]
           for i in range(max(GRAPH_CALLS, len(calls)))]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture
        for fn in calls:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in seq:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * len(seq))
    del graph
    return ms


def device_ops_per_call(torch, fn, iters: int = 10) -> tuple[list, set]:
    """Device operations (kernels, copies, fills) the profiler sees per
    call of ``fn`` in each of three profiles (a synchronise after each
    call), and the names of all of them. The profiler now and then drops
    the records of short kernels (PERF.md), so a reading can fall short
    of the truth; it cannot exceed it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen, names = [], set()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
                torch.cuda.synchronize()
        ops = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA]
        seen.append(sum(ev.count for ev in ops) / iters)
        names.update(ev.key for ev in ops)
    return seen, names


def _decode_timing(torch, ctx, sets, lens_host, *, plain=True,
                   one_kernel=True) -> dict:
    """Times of the decode kernel, called as the decode step calls it
    (lengths on the host and on the card), on ``sets``, a list of (q, k,
    v) of one shape that share ``lens_host``; of SDPA with a boolean
    length mask (a yardstick the port never calls) and of the plain
    version, all by `graph_ms` over the sets in turn; beside the bound
    for the cache rows these lengths make visible. The profiler's time
    of the kernel on the first set stays beside them
    (`kernel_ms_profiler`), and with ``one_kernel`` the profiler must see
    one device kernel per call: one kernel name in all, and in each
    profile some operations but never more than one per call (records
    it drops can only lower a reading)."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops
    q, k, v = sets[0]
    b, hq, hd = q.shape
    s, hkv = k.shape[1], k.shape[2]
    lens_dev = lens_host.to("cuda", torch.int32)

    def kernel(q, k, v):
        return lambda: ops.decode_attention(q, k, v, lens_host,
                                            lengths_dev=lens_dev)

    mask = (torch.arange(s, device="cuda")[None, :]
            < lens_dev[:, None])[:, None, None, :]

    def sdpa(q, k, v):
        return lambda: F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)

    kernel_ms = graph_ms(torch, [kernel(*x) for x in sets])
    library_ms = graph_ms(torch, [sdpa(*x) for x in sets])
    plain_ms = (graph_ms(torch, [(lambda x=x: _dec_plain(*x, lens_dev))
                                 for x in sets], replays=2)
                if plain else None)
    seen, names = device_ops_per_call(torch, kernel(q, k, v))
    per_call = max(seen)
    if one_kernel and (per_call > 1 or min(seen) <= 0 or len(names) != 1):
        raise AssertionError(f"decode_attention: the profiler saw {seen} "
                             f"device operations per call ({names}), not "
                             "one kernel")
    profiler_ms = device_ms(torch, kernel(q, k, v), 20, name="decode_")
    lib_err = float((sdpa(q, k, v)()[:, :, 0].float()
                     - kernel(q, k, v)().float()).abs().max())
    rows = int(lens_host.sum())            # cache rows this run must read
    nbytes = 2 * (2 * rows * hkv * hd + 2 * b * hq * hd) + 4 * b
    flops = 4 * rows * hq * hd
    bw, _, rate_key = card_rates(ctx["kind"])
    peak = bf16_peak(ctx["kind"])
    bytes_ms, ops_ms = nbytes / bw * 1e3, flops / peak * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    shape = dict(b=b, s=s, hq=hq, hkv=hkv, hd=hd,
                 dtype=str(q.dtype).split(".")[-1],
                 lengths=lens_host.tolist(), cache_sets=len(sets),
                 visible_mb_all_sets=len(sets) * nbytes / 1e6)
    if hasattr(ops, "num_splits"):  # not in an older commit's op
        shape["nsplit"] = ops.num_splits(
            b, hkv, s, torch.cuda.get_device_properties(0)
            .multi_processor_count)
    return dict(
        shape=shape, timing="CUDA graph of >= 20 calls cycling the cache "
        "sets, replayed between events", kernel_ms=kernel_ms,
        kernel_ms_profiler=profiler_ms, device_ops_per_call=per_call,
        device_ops_per_call_profiles=seen, device_ops=sorted(names),
        plain_ms=plain_ms, library_ms=library_ms,
        library_max_abs_diff=lib_err, bound_ms=bound_ms,
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        bound_share=bound_ms / kernel_ms,
        bytes=nbytes, bytes_all_s=2 * 2 * b * s * hkv * hd, flops=flops,
        rates=dict(card=rate_key, hbm_bytes_per_s=bw, bf16_flop_per_s=peak),
        achieved_gb_per_s=nbytes / kernel_ms / 1e6)


# yi-9b serving forward: full width and depth, bf16, random weights from a
# seeded generator on the card.
LLM_ARCH = "yi_9b"
PREFILL_SHAPE = (4, 2048)                 # prompts x tokens
DECODE_SLOTS = 8
DECODE_MAX_SEQ = 2048
DECODE_PROMPTS = (16, 32, 48, 64, 80, 96, 112, 128)  # one length per slot
DECODE_NEW = 32                           # greedy tokens per slot
#: relative L2 distance allowed between two paths' logits (PERF.md)
LOGITS_REL_TOL = 5e-2


def _rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def _llm(torch, ctx):
    """yi-9b's config and weights, made once on the card."""
    if "llm" not in ctx:
        from repro_torch.configs import get_config
        from repro_torch.models import transformer as tf
        cfg = get_config(LLM_ARCH)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = tf.init_params(cfg,
                                torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        ctx["llm"] = (cfg, params)
        ctx["llm_init_s"] = time.perf_counter() - t0
    return ctx["llm"]


def _param_bytes(params) -> int:
    if isinstance(params, dict):
        return sum(_param_bytes(v) for v in params.values())
    return params.numel() * params.element_size()


def phase_llm_prefill(torch, ctx):
    import numpy as np
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch.steps import make_prefill_step

    cfg, params = _llm(torch, ctx)
    b, s = PREFILL_SHAPE
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (b, s)), device="cuda")}
    step = make_prefill_step(cfg, impl="kernel")
    with torch.inference_mode():
        ops.flash_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = step(params, batch)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = ops.flash_attention.launches
        ctx["launches"]["flash_attention"] = launches
        if launches != cfg.num_layers:
            raise AssertionError(f"flash_attention launched {launches} "
                                 f"times in one prefill of {cfg.num_layers} "
                                 "layers")
        if tuple(logits.shape) != (b, cfg.vocab_size) or \
                not torch.isfinite(logits).all():
            raise AssertionError("prefill logits are not finite of shape "
                                 f"({b}, {cfg.vocab_size})")
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(params, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        profile = profile_window(torch, lambda: step(params, batch), 1,
                                 min(times) * 1e3)
        ref_step = make_prefill_step(cfg, impl="reference")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = ref_step(params, batch)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
    rel = _rel_l2(logits, ref)
    if rel > LOGITS_REL_TOL:
        raise AssertionError(f"prefill logits: kernel vs reference relative "
                             f"L2 {rel} > {LOGITS_REL_TOL}")
    ms = min(times) * 1e3
    emit(phase="llm_prefill", ok=True, arch=cfg.name,
         layers=cfg.num_layers, params=cfg.param_count(),
         param_bytes=_param_bytes(params), init_s=ctx["llm_init_s"],
         batch=b, seq=s, flash_attention_launches=launches,
         first_call_s=first_s, ms_per_prefill=ms, ms_runs=[t * 1e3
                                                          for t in times],
         tokens_per_s=b * s / (ms / 1e3), reference_ms=ref_s * 1e3,
         logits_rel_l2=rel, logits_max_abs_diff=float(
             (logits.float() - ref.float()).abs().max()),
         logits_abs_max=float(ref.float().abs().max()),
         argmax_equal=int((logits.argmax(-1) == ref.argmax(-1)).sum()),
         rel_tol=LOGITS_REL_TOL, profile=profile)


def phase_llm_decode(torch, ctx):
    """Eight slots with prompts of distinct lengths, fed token by token as
    the serving engine's chunked prefill does (slot b starts when
    128 - len_b steps have passed, so every slot's prompt ends on the same
    step and the per-slot positions differ throughout), then greedy
    tokens. The kernel run picks the tokens; a reference run is fed the
    same tokens, so the two runs' logits compare step by step."""
    import numpy as np
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import transformer as tf

    cfg, params = _llm(torch, ctx)
    serve = make_serve_step(cfg)
    nb = DECODE_SLOTS
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in DECODE_PROMPTS]
    last = max(DECODE_PROMPTS) - 1          # the step of every last prompt token
    start = [last + 1 - n for n in DECODE_PROMPTS]
    steps = last + DECODE_NEW
    check_at = {20: "early", last: "last_prompt", steps - 1: "generating"}
    lens_at = {}
    st_k = tf.init_decode_state(cfg, nb, DECODE_MAX_SEQ, device="cuda")
    st_r = tf.init_decode_state(cfg, nb, DECODE_MAX_SEQ, device="cuda")
    out = [[] for _ in range(nb)]
    rels, agree, step_s, ref_step_s = [], 0, [], []
    cross = None
    with torch.inference_mode():
        ops.decode_attention.launches = 0
        for t in range(steps):
            pos = torch.tensor([max(0, t - start[i]) for i in range(nb)])
            if t in check_at:
                lens_at[check_at[t]] = torch.clamp(
                    pos + 1, max=DECODE_MAX_SEQ).to(torch.int32)
            toks = [int(prompts[i][t - start[i]]) if start[i] <= t <= last
                    else (out[i][-1] if t > last else 0) for i in range(nb)]
            tokens = torch.tensor(toks, device="cuda")[:, None]
            st_k.position = pos
            st_r.position = pos
            before = ops.decode_attention.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lk, st_k = serve(params, tokens, st_k)
            nxt = lk[:, 0].argmax(-1).cpu()
            step_s.append(time.perf_counter() - t0)
            if ops.decode_attention.launches - before != cfg.num_layers:
                raise AssertionError("decode_attention launched "
                                     f"{ops.decode_attention.launches - before}"
                                     f" times in one decode step")
            t0 = time.perf_counter()
            lr, st_r = tf.decode_step(params, cfg, tokens, st_r,
                                      impl="reference")
            nxt_r = lr[:, 0].argmax(-1).cpu()
            ref_step_s.append(time.perf_counter() - t0)
            active = [i for i in range(nb) if t >= start[i]]
            if not torch.isfinite(lk[active]).all():
                raise AssertionError(f"non-finite decode logits at step {t}")
            rels.append(_rel_l2(lk[active], lr[active]))
            if t == last:
                cross = lk[nb - 1, 0].float().clone()
            if t >= last:
                agree += int((nxt == nxt_r).sum())
                for i in range(nb):
                    out[i].append(int(nxt[i]))
        launches = ops.decode_attention.launches
        ctx["launches"]["decode_attention"] = launches
        # the kernel against its plain version on the live caches at the
        # schedule's lengths (these launches are not the path's)
        live = _decode_live_check(torch, ctx, cfg, st_k.caches["kv"][0],
                                  lens_at)
        # a few more generating steps, profiled
        holder = {"state": st_k,
                  "tokens": torch.tensor([o[-1] for o in out],
                                         device="cuda")[:, None]}

        def one_step():
            lg, holder["state"] = serve(params, holder["tokens"],
                                        holder["state"])
            holder["tokens"] = lg[:, 0].argmax(-1, keepdim=True)
            lg[:, 0].argmax(-1).cpu()

        profile = profile_window(torch, one_step, 4,
                                 1e3 * sum(step_s[last:]) / DECODE_NEW)
        # the same prompt through the prefill path
        pre = make_prefill_step(cfg, impl="kernel")(params, {
            "tokens": torch.as_tensor(prompts[nb - 1], device="cuda")[None]})
    cross_rel = _rel_l2(cross, pre[0])
    worst = max(rels)
    if worst > LOGITS_REL_TOL or cross_rel > LOGITS_REL_TOL:
        raise AssertionError(f"decode logits: kernel vs reference relative "
                             f"L2 up to {worst}, decode vs prefill "
                             f"{cross_rel} (limit {LOGITS_REL_TOL})")
    if launches != steps * cfg.num_layers:
        raise AssertionError(f"decode_attention launched {launches} times "
                             f"in {steps} steps")
    gen_s = step_s[last:]
    floor_ms = _param_bytes(params) / card_rates(ctx["kind"])[0] * 1e3
    emit(phase="llm_decode", ok=True, arch=cfg.name, slots=nb,
         max_seq=DECODE_MAX_SEQ, prompt_lengths=list(DECODE_PROMPTS),
         new_tokens=DECODE_NEW, steps=steps,
         decode_attention_launches=launches,
         ms_per_step=1e3 * sum(step_s) / steps,
         ms_per_step_median=1e3 * sorted(step_s)[steps // 2],
         ms_per_step_generating=1e3 * sum(gen_s) / len(gen_s),
         tokens_per_s=nb * steps / sum(step_s),
         reference_ms_per_step=1e3 * sum(ref_step_s) / steps,
         weight_floor_ms=floor_ms, logits_rel_l2_max=worst,
         logits_rel_l2_mean=sum(rels) / len(rels),
         greedy_same_share=agree / (nb * DECODE_NEW),
         decode_vs_prefill_rel_l2=cross_rel, rel_tol=LOGITS_REL_TOL,
         sample_tokens=out[nb - 1][:8], decode_attention_main_path=live,
         profile=profile)
    del ctx["llm"], params, st_k, st_r, holder
    torch.cuda.empty_cache()


def _decode_live_check(torch, ctx, cfg, kv, lens_at, *, label="layer",
                       row=True) -> dict:
    """`decode_attention` on a decode run's own stacked caches ``kv``
    ((L, 8, 2048, Hkv, hd)) of the first and last entries, at the lengths
    the schedule gave an early step, the last prompt token and the last
    generating step, against its plain version (bf16, `_tol`) and the
    plain version in fp32; then its times at the last step's lengths
    over every entry's caches, which set the kernel's row when
    ``row``."""
    from repro_torch.kernels.decode_attention import ops
    gen = torch.Generator(device="cuda").manual_seed(5)
    b = kv["k"].shape[1]

    def query():
        return torch.randn((b, cfg.num_heads, cfg.head_dim), generator=gen,
                           device="cuda").to(kv["k"].dtype)

    errs, fp32 = {}, {}
    for layer in (0, kv["k"].shape[0] - 1):
        kc, vc = kv["k"][layer], kv["v"][layer]
        for name, lens in lens_at.items():
            q, lens_dev = query(), lens.to("cuda")
            got = ops.decode_attention(q, kc, vc, lens, lengths_dev=lens_dev)
            what = f"decode_attention, {label} {layer}, {name} lengths"
            key = f"{label} {layer}, {name}"
            errs[key] = _compare(torch, got, _dec_plain(q, kc, vc, lens_dev),
                                 "bfloat16", what)
            fp32[key] = _hold_fp32(
                torch, got, _dec_plain(q.float(), kc.float(), vc.float(),
                                       lens_dev), "decode_attention", what)
    timing = _decode_timing(
        torch, ctx, [(query(), kv["k"][i], kv["v"][i])
                     for i in range(kv["k"].shape[0])], lens_at["generating"])
    if not row:
        return dict(lengths={k: v.tolist() for k, v in lens_at.items()},
                    max_abs_diff=errs, vs_fp32_plain=fp32, **timing)
    ctx["decode_attention"] = dict(
        max_abs_err=max(list(errs.values())
                        + list(ctx["decode_attention_errs"].values())),
        ms=timing["kernel_ms"], plain_ms=timing["plain_ms"],
        bound_ms=timing["bound_ms"], bound_by=timing["bound_by"],
        library_ms=timing["library_ms"])
    return dict(lengths={k: v.tolist() for k, v in lens_at.items()},
                max_abs_diff=errs, vs_fp32_plain=fp32, **timing)


# ---------------------------------------------------------------------------
# ssd_scan and the ssm / hybrid serving forward (mamba2-370m, zamba2-1.2b)
# ---------------------------------------------------------------------------

# ssd_scan cases: (b, s, h, p, n, chunk, dtype): the reference kernel
# tests' SSD_CASES, chunks that are not powers of two (100 over three
# chunks; 256 on 333 tokens, a padded last chunk), then the prefill
# shapes of the two models, at which the kernel is also held against the
# fp32 plain version and timed.
SSD_CASES = [
    (2, 32, 3, 8, 16, 8, "float32"),
    (1, 64, 2, 16, 32, 16, "float32"),
    (2, 48, 4, 8, 16, 16, "float32"),
    (1, 40, 2, 8, 16, 16, "float32"),      # padding path (40 % 16 != 0)
    (1, 64, 2, 64, 128, 32, "float32"),    # production-ish dims
    (2, 32, 2, 8, 16, 8, "bfloat16"),
    (2, 300, 3, 64, 64, 100, "bfloat16"),  # chunk 100, three chunks
    (1, 333, 2, 16, 32, 256, "float32"),   # padded last chunk
]
SSD_MAIN = {"mamba2-370m": (4, 2048, 32, 64, 128, 256, "bfloat16"),
            "zamba2-1.2b": (4, 2048, 64, 64, 64, 256, "bfloat16")}
SSM_ARCHS = {"ssm": "mamba2_370m", "hybrid": "zamba2_1p2b"}
#: Relative L2 distances allowed, about twice the largest reading on an
#: H100 (PERF.md): between the ssm/hybrid kernel path's prefill logits
#: and impl="reference" run on the same weights in fp32 ("fp32"; read
#: 0.051 mamba2, 0.040 zamba2); between the kernel path's and
#: impl="reference"'s in bf16 ("bf16_ref"; read 0.583 and 0.314: the
#: reference path keeps dt, A, the cumsum and the state in bf16, and its
#: own distance from the fp32 run, printed beside, is 0.582 and 0.312);
#: between the decode path's logits at each slot's last prompt token and
#: the prefill path's ("cross"; read up to 0.041 and 0.030).
SSM_LOGITS_REL_TOL = {
    "fp32": {"mamba2_370m": 0.1, "zamba2_1p2b": 0.1},
    "bf16_ref": {"mamba2_370m": 1.0, "zamba2_1p2b": 0.6},
    "cross": {"mamba2_370m": 0.08, "zamba2_1p2b": 0.08}}


def _ssd_inputs(torch, case, gen):
    """x, B and C as slices of one buffer, as the model's conv output
    hands them; dt = softplus(normal), A = -exp(0.5 * normal)."""
    import torch.nn.functional as F
    b, s, h, p, n, _, dt = case
    buf = torch.randn((b, s, h * p + 2 * n), generator=gen,
                      device="cuda").to(getattr(torch, dt))
    x = buf[..., :h * p].reshape(b, s, h, p)
    dtv = F.softplus(torch.randn((b, s, h), generator=gen, device="cuda"))
    A = -torch.exp(0.5 * torch.randn((h,), generator=gen, device="cuda"))
    return x, dtv, A, buf[..., h * p:h * p + n], buf[..., h * p + n:]


def _ssd_plain(torch, x, dt, A, B, C, chunk):
    """The kernel's plain version as the op runs it on the CPU: fp32, the
    inputs padded by the chunk rule (fp32 result, not cast back)."""
    import torch.nn.functional as F
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    s = x.shape[1]
    chunk = ops.chunk_for(s, chunk)
    pad = (-s) % chunk
    xs = [x.float(), dt.float(), B.float(), C.float()]
    if pad:
        xs = [F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in xs]
    return ssd_scan_ref(xs[0], xs[1], A.float(), xs[2], xs[3],
                        chunk=chunk)[:, :s]


def _ssd_check(torch, x, dt, A, B, C, chunk, what, fp32=False) -> dict:
    """The kernel against its plain version (`_tol` of x's type, after
    the op's cast) and, with ``fp32``, per row against the fp32 plain
    version."""
    from repro_torch.kernels.ssd_scan import ops
    got = ops.ssd_scan(x, dt, A, B, C, chunk=chunk)
    torch.cuda.synchronize()
    want = _ssd_plain(torch, x, dt, A, B, C, chunk)
    dtype = str(x.dtype).split(".")[-1]
    out = dict(max_abs_diff=_compare(torch, got, want.to(got.dtype), dtype,
                                     what))
    if fp32:
        out.update(_hold_fp32(torch, got, want, "ssd_scan", what))
    return out


#: input sets the SSD timing cycles: one set (x, B and C in one buffer,
#: dt, A) is about 36 MB at mamba2 and 69 MB at zamba2, so two exceed the
#: 50 MB L2 and each call finds its inputs cold, as a layer of the
#: prefill does
SSD_TIMING_SETS = 2
#: the profiler's names of the kernels one bf16 call launches: passes (a)
#: chunk states, (b) state passing and (c) chunk scan
SSD_PASSES = {"ssd_scan_states_bf16", "ssd_scan_passing",
              "ssd_scan_chunks_bf16"}


def device_ms_by_kernel(torch, fn, iters: int, stem: str) -> dict:
    """Device ms per call of ``fn`` by kernel, for the kernels whose
    names hold ``stem`` (the C++ name without namespace, template and
    arguments), over one profile of ``iters`` calls. A kernel missing from
    the profile reads as absent: the profiler drops records of short
    kernels now and then (PERF.md)."""
    import re
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for ev in prof.key_averages():
        m = re.search(rf"({stem}\w*)", ev.key)
        if ev.device_type == DeviceType.CUDA and m:
            out[m.group(1)] = (out.get(m.group(1), 0.0)
                               + ev.self_device_time_total / 1e3 / iters)
    return out


def _ssd_timing(torch, ctx, sets, chunk, *, plain=True,
                passes=None) -> dict:
    """Times of the kernel on ``sets`` (lists of x, dt, A, B, C of one
    shape), L2-cold by `graph_ms` over the sets in turn (`kernel_ms`);
    beside it back-to-back calls on the first set timed by events
    (`kernel_ms_eager`), the profiler's time (`kernel_ms_profiler`) and
    its device time by kernel (`passes_ms`; with ``passes`` the names must
    be those), and the plain version's time. The bound: each input read
    once and y written once, and the multiply-adds the chunked scan needs
    (the causal half of C.B^T and of its product with dt*x in every
    chunk; C @ state^T and the state update across each chunk boundary),
    at the bf16 tensor-core peak. No single PyTorch call computes the SSD
    scan, so there is no library time."""
    from repro_torch.kernels.ssd_scan import ops
    x, dt, A, B, C = sets[0]
    b, s, h, p = x.shape
    n = B.shape[2]

    def call(xs):
        return lambda: ops.ssd_scan(*xs, chunk=chunk)

    kernel_ms = graph_ms(torch, [call(xs) for xs in sets])
    eager_ms = cuda_ms(torch, call(sets[0]), 10)
    profiler_ms = device_ms(torch, call(sets[0]), 10, name="ssd_scan")
    for _ in range(3):  # now and then a profile comes back without kernels
        by_kernel = device_ms_by_kernel(torch, call(sets[0]), 10,
                                        "ssd_scan")
        if passes is None or set(by_kernel) == passes:
            break
    else:
        raise AssertionError(f"ssd_scan: one call launched {sorted(by_kernel)}"
                             f", not {sorted(passes)}")
    plain_ms = (cuda_ms(torch, lambda: _ssd_plain(torch, x, dt, A, B, C,
                                                  chunk), 3, warmup=1)
                if plain else None)
    q = ops.chunk_for(s, chunk)
    nc = -(-s // q)
    macs = b * h * (nc * q * (q + 1) // 2 * (n + p)
                    + 2 * (nc - 1) * q * p * n)
    flops = 2 * macs
    es = x.element_size()
    nbytes = 2 * b * s * h * p * es + 4 * b * s * h + 4 * h \
        + 2 * b * s * n * es
    bw, fp32_rate, rate_key = card_rates(ctx["kind"])
    peak = bf16_peak(ctx["kind"])
    bytes_ms, ops_ms = nbytes / bw * 1e3, flops / peak * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    return dict(
        shape=dict(b=b, s=s, h=h, p=p, n=n, chunk=q,
                   dtype=str(x.dtype).split(".")[-1]),
        timing="CUDA graph of >= 24 calls cycling the input sets, replayed "
        "between events", input_sets=len(sets),
        kernel_ms=kernel_ms, kernel_ms_eager=eager_ms,
        kernel_ms_profiler=profiler_ms, passes_ms=by_kernel,
        plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        bound_share=bound_ms / kernel_ms,
        bytes=nbytes, flops=flops, fp32_cuda_core_ms=flops / fp32_rate * 1e3,
        rates=dict(card=rate_key, hbm_bytes_per_s=bw, bf16_flop_per_s=peak,
                   fp32_flop_per_s=fp32_rate),
        achieved_tflop_per_s=flops / kernel_ms / 1e9)


def phase_ssd_scan(torch, ctx):
    from repro_torch.kernels import build
    ptxas = ptxas_functions(build.PTXAS_LOG.get("ssd_scan", ""))
    spills = {k: v for k, v in ptxas.items() if "bf16" in k
              and (v.get("spill_stores") or v.get("spill_loads"))}
    if spills:
        raise AssertionError(f"ssd_scan: the bf16 kernels spill: {spills}")
    gen = torch.Generator(device="cuda").manual_seed(6)
    errs, fp32, timing = {}, {}, {}
    for case in SSD_CASES:
        x, dt, A, B, C = _ssd_inputs(torch, case, gen)
        errs[str(case)] = _ssd_check(torch, x, dt, A, B, C, case[5],
                                     f"ssd_scan {case}")["max_abs_diff"]
    for name, case in SSD_MAIN.items():
        x, dt, A, B, C = _ssd_inputs(torch, case, gen)
        res = _ssd_check(torch, x, dt, A, B, C, case[5], f"ssd_scan {case}",
                         fp32=True)
        errs[str(case)] = res.pop("max_abs_diff")
        fp32[name] = res
        sets = [(x, dt, A, B, C)] + [_ssd_inputs(torch, case, gen)
                                     for _ in range(SSD_TIMING_SETS - 1)]
        timing[name] = _ssd_timing(torch, ctx, sets, case[5],
                                   passes=SSD_PASSES)
        del x, dt, A, B, C, sets
    m = timing["mamba2-370m"]
    ctx["ssd_scan"] = dict(
        max_abs_err=max(errs.values()), ms=m["kernel_ms"],
        plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
        bound_by=m["bound_by"], library_ms=None)
    ctx["ssd_scan_errs"] = errs
    emit(phase="ssd_scan", ok=True, ptxas=ptxas, max_abs_diff=errs,
         vs_fp32_plain=fp32,
         fp32_row_rel_tol=FP32_ROW_REL_TOL["ssd_scan"], timing=timing,
         library="none: no single PyTorch call computes the SSD scan")
    torch.cuda.empty_cache()


def _ssm_model(torch, ctx, arch):
    """The model's config and weights (seed 0, on the card), made once
    per arch; the previous arch's weights are dropped first."""
    held = ctx.get("ssm_model")
    if held is None or held[0] != arch:
        from repro_torch.configs import get_config
        from repro_torch.models import transformer as tf
        ctx.pop("ssm_model", None)
        del held
        torch.cuda.empty_cache()
        cfg = get_config(arch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = tf.init_params(cfg,
                                torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        ctx["ssm_model"] = (arch, cfg, params, time.perf_counter() - t0)
    return ctx["ssm_model"][1:]


def _fp32_params(params):
    """The same weights in fp32 (bf16 -> fp32 is exact)."""
    if isinstance(params, dict):
        return {k: _fp32_params(v) for k, v in params.items()}
    return params.float()


def _ssd_live_check(torch, cfg, params, tokens, layers) -> dict:
    """`ssd_scan` on the live scan inputs of ``layers`` (the prefill's own
    activations, walked layer by layer as the forward does) against its
    plain version in bf16 and per row in fp32."""
    from repro_torch.models import mamba2, transformer as tf
    from repro_torch.models.layers import embed, rmsnorm
    out = {}
    x = embed(params["embed"], tokens)
    apps = tf.num_shared_attn_apps(cfg)
    for i in range(cfg.num_layers):
        bp = tf._layer(params["blocks"], i)
        if i in layers:
            _, xs = mamba2.scan_inputs(
                bp["mamba"], cfg, rmsnorm(bp["ln"], x, cfg.norm_eps))
            out[f"layer {i}"] = _ssd_check(
                torch, *xs, cfg.ssm_chunk, f"ssd_scan, {cfg.name} layer {i}",
                fp32=True)
            del xs
        x = tf._mamba_block(bp, cfg, x, impl="kernel")
        if apps and (i + 1) % cfg.attn_every == 0 \
                and (i + 1) // cfg.attn_every <= apps:
            x = tf._attn_mlp_block(params["shared_attn"], cfg, x,
                                   window=cfg.sliding_window, prefix=0,
                                   impl="kernel")
    return out


def _ssm_prefill(torch, ctx, arch, phase):
    """The prefill step on 4 prompts of 2048 tokens: `ssd_scan` once per
    Mamba2 layer and `flash_attention` once per application of the shared
    block, logits against impl="reference", times and a profile, and the
    kernel on the live inputs of the first and last layers."""
    import numpy as np
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as tf

    cfg, params, init_s = _ssm_model(torch, ctx, arch)
    b, s = PREFILL_SHAPE
    rng = np.random.default_rng(7)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (b, s)), device="cuda")}
    step = make_prefill_step(cfg)
    want = {"ssd_scan": cfg.num_layers,
            "flash_attention": tf.num_shared_attn_apps(cfg)}
    with torch.inference_mode():
        ssd.ssd_scan.launches = 0
        fa.flash_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = step(params, batch)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = {"ssd_scan": ssd.ssd_scan.launches,
                    "flash_attention": fa.flash_attention.launches}
        if launches != want:
            raise AssertionError(f"{cfg.name} prefill launched {launches}, "
                                 f"not {want}")
        if tuple(logits.shape) != (b, cfg.vocab_size) or \
                not torch.isfinite(logits).all():
            raise AssertionError("prefill logits are not finite of shape "
                                 f"({b}, {cfg.vocab_size})")
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(params, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        profile = profile_window(torch, lambda: step(params, batch), 1,
                                 min(times) * 1e3)
        ref_step = make_prefill_step(cfg, impl="reference")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = ref_step(params, batch)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        torch.backends.cuda.matmul.allow_tf32 = False    # full fp32 GEMMs
        ref32 = ref_step(_fp32_params(params), batch)
        live = _ssd_live_check(torch, cfg, params, batch["tokens"],
                               (0, cfg.num_layers - 1))
    rels = dict(fp32=_rel_l2(logits, ref32), bf16_ref=_rel_l2(logits, ref),
                bf16_ref_vs_fp32=_rel_l2(ref, ref32))
    for key in ("fp32", "bf16_ref"):
        if rels[key] > SSM_LOGITS_REL_TOL[key][arch]:
            raise AssertionError(
                f"{cfg.name} prefill logits: kernel path vs impl=reference "
                f"({key}) relative L2 {rels[key]} > "
                f"{SSM_LOGITS_REL_TOL[key][arch]}")
    torch.cuda.empty_cache()
    ms = min(times) * 1e3
    emit(phase=phase, ok=True, arch=cfg.name, layers=cfg.num_layers,
         shared_attn_apps=want["flash_attention"], params=cfg.param_count(),
         param_bytes=_param_bytes(params), init_s=init_s, batch=b, seq=s,
         launches=launches, first_call_s=first_s, ms_per_prefill=ms,
         ms_runs=[t * 1e3 for t in times], tokens_per_s=b * s / (ms / 1e3),
         reference_ms=ref_s * 1e3, logits_rel_l2=rels,
         logits_max_abs_diff_vs_fp32=float(
             (logits.float() - ref32.float()).abs().max()),
         logits_abs_max=float(ref32.float().abs().max()),
         argmax_equal_vs_fp32=int((logits.argmax(-1) == ref32.argmax(-1))
                                  .sum()),
         rel_tol={k: v[arch] for k, v in SSM_LOGITS_REL_TOL.items()
                  if k != "cross"}, ssd_scan_live=live,
         fp32_row_rel_tol=FP32_ROW_REL_TOL["ssd_scan"], profile=profile)
    return launches


def phase_ssm_prefill(torch, ctx):
    launches = _ssm_prefill(torch, ctx, SSM_ARCHS["ssm"], "ssm_prefill")
    ctx["launches"]["ssd_scan"] = launches["ssd_scan"]


def phase_hybrid_prefill(torch, ctx):
    _ssm_prefill(torch, ctx, SSM_ARCHS["hybrid"], "hybrid_prefill")


def _ssm_decode(torch, ctx, arch, phase):
    """Eight slots with prompts of 16..128 tokens fed token by token at
    per-slot positions through `make_serve_step`, then 32 greedy tokens,
    on the schedule of `phase_llm_decode`; a slot's recurrent state is
    zeroed when its prompt starts, as the serving engine does when it
    admits a request. Per step: the hand-written kernels launched
    (`decode_attention` once per application of the shared block, none
    for mamba2) and, with a shared block, the logits against a
    decode_step(impl="reference") run fed the same tokens. Then each
    slot's logits at its last prompt token against the prefill step on
    that prompt."""
    import numpy as np
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import transformer as tf

    cfg, params, _ = _ssm_model(torch, ctx, arch)
    serve = make_serve_step(cfg)
    apps = tf.num_shared_attn_apps(cfg)
    nb = DECODE_SLOTS
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in DECODE_PROMPTS]
    last = max(DECODE_PROMPTS) - 1
    start = [last + 1 - n for n in DECODE_PROMPTS]
    steps = last + DECODE_NEW
    check_at = {20: "early", last: "last_prompt", steps - 1: "generating"}
    lens_at = {}
    states = [tf.init_decode_state(cfg, nb, DECODE_MAX_SEQ, device="cuda")
              for _ in range(2 if apps else 1)]
    out = [[] for _ in range(nb)]
    rels, agree, step_s = [], 0, []

    def counts():
        return (ssd.ssd_scan.launches, fa.flash_attention.launches,
                dec.decode_attention.launches)

    with torch.inference_mode():
        ssd.ssd_scan.launches = fa.flash_attention.launches = 0
        dec.decode_attention.launches = 0
        for t in range(steps):
            pos = torch.tensor([max(0, t - start[i]) for i in range(nb)])
            if t in check_at:
                lens_at[check_at[t]] = torch.clamp(
                    pos + 1, max=DECODE_MAX_SEQ).to(torch.int32)
            for i in range(nb):
                if t == start[i] > 0:
                    for st in states:
                        for c in st.caches["ssm"].values():
                            c[:, i].zero_()
            toks = [int(prompts[i][t - start[i]]) if start[i] <= t <= last
                    else (out[i][-1] if t > last else 0) for i in range(nb)]
            tokens = torch.tensor(toks, device="cuda")[:, None]
            for st in states:
                st.position = pos
            before = counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lk, states[0] = serve(params, tokens, states[0])
            nxt = lk[:, 0].argmax(-1).cpu()
            step_s.append(time.perf_counter() - t0)
            moved = tuple(a - b for a, b in zip(counts(), before))
            if moved != (0, 0, apps):
                raise AssertionError(f"one decode step launched ssd_scan, "
                                     f"flash_attention, decode_attention "
                                     f"{moved} times, not (0, 0, {apps})")
            active = [i for i in range(nb) if t >= start[i]]
            if not torch.isfinite(lk[active]).all():
                raise AssertionError(f"non-finite decode logits at step {t}")
            if apps:
                lr, states[1] = tf.decode_step(params, cfg, tokens,
                                               states[1], impl="reference")
                rels.append(_rel_l2(lk[active], lr[active]))
                if t >= last:
                    agree += int((nxt == lr[:, 0].argmax(-1).cpu()).sum())
            if t == last:
                at_last = lk[:, 0].float().clone()
            if t >= last:
                for i in range(nb):
                    out[i].append(int(nxt[i]))
        launches = counts()
        live = (_decode_live_check(torch, ctx, cfg,
                                   states[0].caches["shared_kv"], lens_at,
                                   label="application", row=False)
                if apps else None)
        holder = {"state": states[0],
                  "tokens": torch.tensor([o[-1] for o in out],
                                         device="cuda")[:, None]}

        def one_step():
            lg, holder["state"] = serve(params, holder["tokens"],
                                        holder["state"])
            holder["tokens"] = lg[:, 0].argmax(-1, keepdim=True)
            lg[:, 0].argmax(-1).cpu()

        gen_ms = 1e3 * sum(step_s[last:]) / DECODE_NEW
        profile = profile_window(torch, one_step, 4, gen_ms)
        # each slot's last prompt token through the prefill path: chunks
        # of the prompt's own length (16..128), most not powers of two
        prefill = make_prefill_step(cfg)
        cross = [_rel_l2(at_last[i], prefill(params, {"tokens": torch.as_tensor(
            prompts[i], device="cuda")[None]})[0]) for i in range(nb)]
    worst = max(rels) if rels else None
    cross_tol = SSM_LOGITS_REL_TOL["cross"][arch]
    if max(cross) > cross_tol or (worst is not None
                                  and worst > LOGITS_REL_TOL):
        raise AssertionError(f"{cfg.name} decode logits: decode vs prefill "
                             f"relative L2 up to {max(cross)} (limit "
                             f"{cross_tol}), kernel vs reference up to "
                             f"{worst} (limit {LOGITS_REL_TOL})")
    gen_s = step_s[last:]
    emit(phase=phase, ok=True, arch=cfg.name, slots=nb,
         max_seq=DECODE_MAX_SEQ, prompt_lengths=list(DECODE_PROMPTS),
         new_tokens=DECODE_NEW, steps=steps,
         hand_written_kernel_launches=dict(zip(
             ("ssd_scan", "flash_attention", "decode_attention"), launches)),
         hand_written_kernels=("decode_attention in the shared block" if apps
                               else "none: the Mamba2 decode step is plain "
                               "PyTorch"),
         ms_per_step=1e3 * sum(step_s) / steps,
         ms_per_step_median=1e3 * sorted(step_s)[steps // 2],
         ms_per_step_generating=1e3 * sum(gen_s) / len(gen_s),
         tokens_per_s=nb * steps / sum(step_s),
         weight_floor_ms=_param_bytes(params) / card_rates(ctx["kind"])[0]
         * 1e3,
         decode_vs_prefill_rel_l2=cross, cross_rel_tol=cross_tol,
         logits_rel_l2_max=worst,
         logits_rel_l2_mean=sum(rels) / len(rels) if rels else None,
         greedy_same_share=agree / (nb * DECODE_NEW) if apps else None,
         rel_tol=LOGITS_REL_TOL if apps else None,
         sample_tokens=out[nb - 1][:8], decode_attention_live=live,
         profile=profile)
    del states, holder


def phase_ssm_decode(torch, ctx):
    _ssm_decode(torch, ctx, SSM_ARCHS["ssm"], "ssm_decode")


def phase_hybrid_decode(torch, ctx):
    _ssm_decode(torch, ctx, SSM_ARCHS["hybrid"], "hybrid_decode")
    ctx.pop("ssm_model", None)
    torch.cuda.empty_cache()


# gossip_combine cases: (K, T, dtype, offset). The reference kernel tests'
# cases (tests/test_kernels.py), T = 65537, T = 0, bf16 at an odd width,
# and K = 1..6 at odd T with the weights starting `offset` elements into
# their buffer, so that rows lie off the 16-byte grid.
GC_CASES = [(2, 1024, "float32", 0), (5, 4096, "float32", 0),
            (8, 1000, "float32", 0), (3, 70000, "float32", 0),
            (4, 4096, "bfloat16", 0), (3, 65537, "float32", 0),
            (3, 65537, "bfloat16", 0), (2, 0, "float32", 0),
            (8, 4099, "bfloat16", 0)] + [
    (k, 4099 + 2 * k, dt, k % 4) for k in range(1, 7)
    for dt in ("float32", "bfloat16")]
#: The ring round's combine: self, left, right over mamba2-370m packed
#: flat in fp32.
GC_RING = (3, 368_226_304)


def phase_gossip_combine(torch, ctx):
    """The kernel against its plain version, bit for bit, on GC_CASES and
    at the ring's shape, where it is timed beside the plain version, a
    cuBLAS GEMV (`coeffs @ weights`, a yardstick the port never calls)
    and the bound."""
    from repro_torch.kernels.gossip_combine import ops
    from repro_torch.kernels.gossip_combine.ref import gossip_combine_ref

    gen = torch.Generator(device="cuda").manual_seed(11)
    errs = {}

    def check(w, a, what):
        got = ops.gossip_combine(w, a)
        want = gossip_combine_ref(w, a)
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != w.dtype:
            raise AssertionError(f"gossip_combine {what}: {got.shape} "
                                 f"{got.dtype}, not {want.shape} {w.dtype}")
        errs[what] = float((got.float() - want.float()).abs().max()) \
            if got.numel() else 0.0
        if not torch.equal(got, want):
            raise AssertionError(f"gossip_combine {what}: kernel and plain "
                                 f"version differ, max |diff| {errs[what]}")
        return got

    for case in GC_CASES:
        k, t, dt, off = case
        buf = torch.randn((k * t + off,), generator=gen, device="cuda")
        w = buf.to(getattr(torch, dt))[off:].view(k, t)
        a = torch.rand((k,), generator=gen, device="cuda")
        check(w, a / a.sum(), str(case))
        del buf, w

    k, t = GC_RING
    w = torch.randn((k, t), generator=gen, device="cuda")
    a = torch.full((k,), 1.0 / 3.0, device="cuda")
    got = check(w, a, f"ring {GC_RING}")
    before = ops.gossip_combine.launches
    kernel_ms = cuda_ms(torch, lambda: ops.gossip_combine(w, a), 20)
    if ops.gossip_combine.launches != before + 23:
        raise AssertionError("gossip_combine did not launch once per call")
    plain_ms = cuda_ms(torch, lambda: gossip_combine_ref(w, a), 5, warmup=1)
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    library_ms = cuda_ms(torch, lambda: a @ w, 20)
    lib_diff = float((a @ w - got).abs().max())
    torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    del w, got
    torch.cuda.empty_cache()

    bw, fp32, rate_key = card_rates(ctx["kind"])
    nbytes = (k + 1) * t * 4 + k * 4
    flops = 2 * k * t
    bytes_ms, ops_ms = nbytes / bw * 1e3, flops / fp32 * 1e3
    ctx["gossip_combine"] = dict(
        max_abs_err=max(errs.values()), ms=kernel_ms, plain_ms=plain_ms,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=library_ms)
    emit(phase="gossip_combine", ok=True, cases=len(errs),
         max_abs_diff=errs, shape=dict(k=k, t=t, dtype="float32"),
         kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
         library="coeffs @ weights (cuBLAS GEMV, TF32 off)",
         library_max_abs_diff=lib_diff, bound_ms=max(bytes_ms, ops_ms),
         bytes=nbytes, flops=flops,
         rates=dict(card=rate_key, hbm_bytes_per_s=bw, fp32_flop_per_s=fp32),
         achieved_gb_per_s=nbytes / kernel_ms / 1e6)


#: Rounds per state in the timed ring runs.
RING_ROUNDS = 3


def _leafwise(fn, *trees, path=""):
    """``fn(path, *leaves)`` over the leaves of same-shaped nested dicts."""
    if isinstance(trees[0], dict):
        for k in sorted(trees[0]):
            _leafwise(fn, *(t[k] for t in trees), path=f"{path}/{k}")
    else:
        fn(path, *trees)


def _ring_checks(torch, cfg, axis, dev) -> dict:
    """One round per state from seeded weights on ``dev``, and the checks
    of `phase_ring_gossip`; raises on the first that fails."""
    from repro_torch.fl import gossip
    from repro_torch.kernels.gossip_combine import ops
    from repro_torch.launch import fl8
    from repro_torch.launch.mesh import tree_bytes, tree_leaves, tree_map

    n = axis.size
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    params = fl8.init_silos(cfg, axis, dev)
    bufs = gossip.init_ring_buffers(params)
    rep = tree_bytes(params) // n
    out = dict(replica_bytes=rep)

    def round_(p, b, left, right, use_kernel=True):
        ops.gossip_combine.launches = 0
        axis.bytes_moved = 0
        res = fl8.build_step(cfg, left, right, axis, use_kernel)(p, b)
        sync()
        want = n if use_kernel and dev.type == "cuda" else 0
        if ops.gossip_combine.launches != want:
            raise AssertionError(f"{ops.gossip_combine.launches} "
                                 f"gossip_combine launches in a round on "
                                 f"{n} silos, not {want}")
        moved = (int(left) + int(right)) * n * rep
        if axis.bytes_moved != moved:
            raise AssertionError(f"{axis.bytes_moved} bytes crossed the "
                                 f"silo axis, not {moved}")
        return res

    def equal(what):
        def fn(name, a, b):
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"{what}: {name} differs")
        return fn

    # overlay: fresh buffers are the rolls; the elementwise path agrees
    new, nb = round_(params, bufs, True, True)
    del bufs
    _leafwise(equal("overlay: left buffer vs roll(+1)"), nb["left"],
              tree_map(lambda x: torch.roll(x, 1, 0), params))
    _leafwise(equal("overlay: right buffer vs roll(-1)"), nb["right"],
              tree_map(lambda x: torch.roll(x, -1, 0), params))
    plain = round_(params, nb, True, True, use_kernel=False)[0]
    _leafwise(equal("overlay: kernel path vs elementwise path"), new, plain)
    del plain

    # overlay against gossip_dense with the ring's Metropolis matrix:
    # |dense - ring| <= eps * sum_j |A_ij| |w_j|, eps one bf16 ulp (2^-7)
    # for bf16 leaves and 2^-20 for fp32 leaves (another summation order)
    a = gossip.ring_matrix(n)
    dense = gossip.gossip_dense(params, a, axis)
    worst = {"bfloat16": 0.0, "float32": 0.0}

    def near(name, d, r, w):
        key = str(w.dtype).split(".")[-1]
        eps = 2.0 ** (-7 if key == "bfloat16" else -20)
        for s in range(n):
            mag = sum(float(a[s, j]) * w[j].float().abs()
                      for j in range(n) if a[s, j] != 0)
            diff = (d[s].float() - r[s].float()).abs()
            if bool((diff > eps * mag).any()):
                raise AssertionError(f"gossip_dense vs ring round: {name} "
                                     f"silo {s}, max |diff| "
                                     f"{float(diff.max())}")
            worst[key] = max(worst[key], float(diff.max()))
    _leafwise(near, dense, new, params)
    out["dense_vs_ring_max_abs_diff"] = worst
    del dense

    # half: the right direction is weak, so the left buffer stays stale
    # (here the rolls of the first weights) and the right one is fresh
    params2, nb2 = round_(new, nb, True, False)
    if nb2["left"] is not nb["left"]:
        raise AssertionError("half: the left buffer was not kept")
    _leafwise(equal("half: right buffer vs roll(-1)"), nb2["right"],
              tree_map(lambda x: torch.roll(x, -1, 0), new))
    del params2, nb2

    # isolated: nothing crosses, the stale buffers (the rolls of the first
    # weights, not of `new`) are read as they are
    iso, nb3 = round_(new, nb, False, False)
    if nb3["left"] is not nb["left"] or nb3["right"] is not nb["right"]:
        raise AssertionError("isolated: the stale buffers were not kept")
    third = torch.tensor(1.0 / 3.0, device=dev)

    def by_hand(name, got, w, lb, rb):
        want = (third * w.float() + third * lb.float()
                + third * rb.float()).to(w.dtype)
        equal("isolated: round vs the stale-buffer sum by hand")(
            name, got, want)
    _leafwise(by_hand, iso, new, nb["left"], nb["right"])
    plain = round_(new, nb, False, False, use_kernel=False)[0]
    _leafwise(equal("isolated: kernel path vs elementwise path"), iso, plain)
    out["isolated_differs_from_fresh"] = not all(
        torch.equal(x, torch.roll(y, 1, 0))
        for x, y in zip(tree_leaves(nb["left"]), tree_leaves(new)))
    if not out["isolated_differs_from_fresh"]:
        raise AssertionError("isolated: stale buffers equal fresh ones, the "
                             "check cannot tell them apart")
    return out


def phase_ring_gossip(torch, ctx):
    """`launch/fl8` on `StackedSilos(8)`: eight mamba2-370m replicas at
    full width and depth, bf16, each from its own seeded generator on the
    card. First one round per state with its checks (`_ring_checks`):
    8 `gossip_combine` launches a round, the silo-axis bytes (2, 1 and 0
    replicas per silo), fresh buffers bit-equal to the rolls, the kernel
    path bit-equal to the elementwise path, the overlay round against
    `gossip_dense` with the ring's Metropolis matrix, and an isolated
    round that moves nothing and reads the stale buffers. Then
    `fl8.run_state` times RING_ROUNDS rounds of each state (launch counts
    zeroed just before each, read just after), and one overlay round is
    profiled."""
    from repro_torch.configs import get_config
    from repro_torch.fl import gossip
    from repro_torch.kernels.gossip_combine import ops
    from repro_torch.launch import fl8
    from repro_torch.launch.mesh import StackedSilos

    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False   # gossip_dense in fp32
    cfg = get_config(fl8.ARCH)
    axis = StackedSilos(fl8.N_SILOS)
    checks = _ring_checks(torch, cfg, axis, dev)
    torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    torch.cuda.empty_cache()

    states, launches = {}, 0
    for name, left, right in fl8.STATES:
        rep = fl8.run_state(name, fl8.ARCH, left, right, axis=axis,
                            device=dev, rounds=RING_ROUNDS)
        if rep["gossip_combine_launches"] != fl8.N_SILOS * RING_ROUNDS:
            raise AssertionError(f"{name}: {rep['gossip_combine_launches']} "
                                 f"gossip_combine launches in {RING_ROUNDS} "
                                 f"rounds, not {fl8.N_SILOS} a round")
        launches += rep["gossip_combine_launches"]
        rep["kernel_share"] = (ctx["gossip_combine"]["ms"]
                               * rep["launches_per_round"]
                               / rep["ms_per_round"])
        states[name] = rep
        torch.cuda.empty_cache()
    ctx["launches"]["gossip_combine"] = launches

    params = fl8.init_silos(cfg, axis, dev)
    bufs = gossip.init_ring_buffers(params)
    step = fl8.build_step(cfg, True, True, axis)
    profile = profile_window(torch, lambda: step(params, bufs), 2,
                             states["overlay"]["ms_per_round"])
    profile["gossip_combine_device_ms"] = sum(
        k["device_ms"] for k in profile["top_kernels"]
        if "gossip_combine" in k["kernel"])
    del params, bufs, step
    torch.cuda.empty_cache()
    emit(phase="ring_gossip", ok=True, arch=cfg.name, silos=axis.size,
         params_per_replica=cfg.param_count(), rounds=RING_ROUNDS,
         checks=checks, states=states, profile_overlay=profile,
         launches=launches, gossip_combine_ms=ctx["gossip_combine"]["ms"],
         gossip_combine_bound_ms=ctx["gossip_combine"]["bound_ms"])


#: Name stems of the port's hand-written kernels in a profile.
HAND_WRITTEN = ("edge_aggregate", "gossip_combine", "flash_fwd",
                "decode_attn", "ssd_scan")


def profile_window(torch, fn, iters: int, unprofiled_ms: float) -> dict:
    """Where ``iters`` calls of ``fn`` spend their time: device time by
    kernel name, the device's busy time per call and its idle share
    against the unprofiled time per call, each hand-written kernel's device
    time per call, and the host operators with the most CPU time of their
    own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / iters
    events = prof.key_averages()
    kern = sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in events if ev.device_type == DeviceType.CUDA
                   and ev.self_device_time_total > 0), reverse=True)
    host = sorted(((ev.self_cpu_time_total, ev.key, ev.count)
                   for ev in events if ev.device_type == DeviceType.CPU
                   and ev.self_cpu_time_total > 0), reverse=True)
    busy = sum(x[0] for x in kern) / 1e3 / iters
    return dict(
        calls=iters, device_busy_ms=busy, profiled_wall_ms=wall,
        unprofiled_ms=unprofiled_ms,
        idle_share=max(0.0, 1 - busy / unprofiled_ms),
        kernel_launches=sum(x[2] for x in kern) // iters,
        top_kernels=[dict(kernel=k[:90], device_ms=us / 1e3 / iters,
                          calls=c // iters) for us, k, c in kern[:10]],
        hand_written_ms={name: sum(us for us, k, _ in kern if name in k)
                         / 1e3 / iters for name in HAND_WRITTEN},
        top_host_ops=[dict(op=k[:60], cpu_ms=us / 1e3 / iters,
                           calls=c // iters) for us, k, c in host[:10]])


def _kernel_row(ctx, name, replaces) -> dict:
    return dict(name=name, route="cuda",
                source=f"src/repro_torch/csrc/{name}.cu", replaces=replaces,
                launches=ctx["launches"].get(name, 0), **ctx[name])


def decode_bench(torch, src: Path) -> int:
    """``python3 chip_smoke.py --decode-bench DIR`` times the decode
    kernel of the port under DIR/src (this checkout, or another commit
    unpacked into a directory that .gitignore lists, so that two commits
    compare in one call) by `_decode_timing` at the three decode shapes,
    on random bf16 caches: yi-9b's 48 layers (8, 2048, 4, 128) and
    zamba2's 6 shared-block caches (8, 2048, 32, 64) at the decode runs'
    last lengths, and DEC_MAIN_COPIES copies of DEC_MAIN at seeded random
    lengths. Prints one JSON line."""
    sys.path.insert(0, str(src / "src"))
    from repro_torch.kernels.decode_attention import ops
    ctx = {"kind": torch.cuda.get_device_name(0), "smi": nvidia_smi_line()}
    gen = torch.Generator(device="cuda").manual_seed(7)
    # the decode runs' last generating step: prompt + DECODE_NEW - 1 tokens
    live = torch.tensor([n + DECODE_NEW - 1 for n in DECODE_PROMPTS],
                        dtype=torch.int32)
    main_lens = torch.randint(1, DEC_MAIN[3] + 1, (DEC_MAIN[0],),
                              generator=torch.Generator().manual_seed(7),
                              dtype=torch.int32)
    shapes = {"yi-9b decode": ((8, 32, 4, 2048, 128, "bfloat16"), 48, live),
              "DEC_MAIN": (DEC_MAIN, DEC_MAIN_COPIES, main_lens),
              "zamba2 decode": ((8, 32, 32, 2048, 64, "bfloat16"), 6, live)}
    out = {}
    for name, (case, n, lens) in shapes.items():
        b, hq, _, _, hd, dt = case
        sets = [(torch.randn((b, hq, hd), generator=gen, device="cuda")
                 .to(getattr(torch, dt)), *_dec_caches(torch, case, gen))
                for _ in range(n)]
        out[name] = _decode_timing(torch, ctx, sets, lens, plain=False,
                                   one_kernel=False)
        del sets
        torch.cuda.empty_cache()
    print(json.dumps({"decode_bench": str(src), "ops": ops.__file__,
                      "nvidia_smi": ctx["smi"], "shapes": out}), flush=True)
    return 0


def ssd_bench(torch, src: Path) -> int:
    """``python3 chip_smoke.py --ssd-bench DIR`` times the SSD scan of the
    port under DIR/src (this checkout, or another commit unpacked into a
    directory that .gitignore lists, so that two commits compare in one
    call) by `_ssd_timing` at both SSD_MAIN shapes, on SSD_TIMING_SETS
    seeded input sets each. Prints one JSON line."""
    sys.path.insert(0, str(src / "src"))
    from repro_torch.kernels.ssd_scan import ops
    ctx = {"kind": torch.cuda.get_device_name(0), "smi": nvidia_smi_line()}
    gen = torch.Generator(device="cuda").manual_seed(6)
    out = {}
    for name, case in SSD_MAIN.items():
        sets = [_ssd_inputs(torch, case, gen)
                for _ in range(SSD_TIMING_SETS)]
        out[name] = _ssd_timing(torch, ctx, sets, case[5], plain=False)
        del sets
        torch.cuda.empty_cache()
    print(json.dumps({"ssd_bench": str(src), "ops": ops.__file__,
                      "nvidia_smi": ctx["smi"], "shapes": out}), flush=True)
    return 0


#: Timed FEMNIST cycles per `--cycle-bench` process.
CYCLE_BENCH_TURNS = 6


def cycle_bench(torch, src: Path) -> int:
    """``python3 chip_smoke.py --cycle-bench DIR`` times the FEMNIST
    multigraph cycle (gaia, batch 32) of the port under DIR/src (this
    checkout, or another commit unpacked into a directory that .gitignore
    lists, so that two commits compare in one call) by `_cycle_timing`,
    CYCLE_BENCH_TURNS times, with the deterministic settings of the
    `run_fl` phases. Prints one JSON line."""
    sys.path.insert(0, str(src / "src"))
    from repro_torch.fl import runtime
    _deterministic(torch)
    out = _cycle_timing(torch, "femnist", ("kernel",) * CYCLE_BENCH_TURNS)
    print(json.dumps({"cycle_bench": str(src), "runtime": runtime.__file__,
                      "nvidia_smi": nvidia_smi_line(), **out}), flush=True)
    return 0


BENCHES = {"--decode-bench": decode_bench, "--ssd-bench": ssd_bench,
           "--cycle-bench": cycle_bench}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] in BENCHES:
        import torch
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device", file=sys.stderr)
            return 1
        return BENCHES[sys.argv[1]](torch, Path(sys.argv[2]).resolve())
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    ctx: dict = {"launches": {}}
    phases = [phase_device, phase_build, phase_edge_aggregate, phase_run_fl,
              phase_cycle, phase_flash_attention, phase_decode_attention,
              phase_llm_prefill, phase_llm_decode, phase_ssd_scan,
              phase_ssm_prefill, phase_ssm_decode, phase_hybrid_prefill,
              phase_hybrid_decode, phase_gossip_combine, phase_ring_gossip,
              phase_run_fl_surface, phase_run_fl_models, phase_topologies]
    for phase in phases:
        try:
            phase(torch, ctx)
        except Exception as exc:
            emit(phase=phase.__name__[len("phase_"):], ok=False,
                 error=f"{type(exc).__name__}: {exc}")
            traceback.print_exc()
            return 1
    wan64 = ctx["edge_aggregate_shapes"]["femnist_wan64"]
    print(json.dumps({"kernels": [
        _kernel_row(ctx, "edge_aggregate",
                    "src/repro/kernels/gossip_combine/kernel.py:114"),
        dict(_kernel_row(ctx, "edge_aggregate",
                         "src/repro/kernels/gossip_combine/kernel.py:114"),
             shape="wan64: N=64, 2E=128, T=1,280,478",
             launches=ctx["launches"]["edge_aggregate_wan64"],
             **{k: wan64[k] for k in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms")}),
        _kernel_row(ctx, "gossip_combine",
                    "src/repro/kernels/gossip_combine/kernel.py:46"),
        _kernel_row(ctx, "flash_attention",
                    "src/repro/kernels/flash_attention/kernel.py:104"),
        _kernel_row(ctx, "decode_attention",
                    "src/repro/kernels/decode_attention/kernel.py:75"),
        _kernel_row(ctx, "ssd_scan",
                    "src/repro/kernels/ssd_scan/kernel.py:71")]}))
    print(ctx["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": ctx["kind"], "count": ctx["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
