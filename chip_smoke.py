#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card, as torch and nvidia-smi name it;
2. build: nvcc builds every CUDA kernel from src/repro_torch/csrc, one
   process per source, all at once;
3. edge_aggregate: the kernel against its plain PyTorch version on the
   card, at the main path's shape (N=11 silos, 2E=22 directed edges of
   the gaia multigraph, T=1,280,478 FEMNIST CNN parameters) and on an
   odd-width case with an isolated destination; the two must agree bit
   for bit. Times the kernel, the plain version and one library call
   (`torch.addmm` over the dense coefficient matrix, a yardstick the
   port never calls) beside the least time the card could take;
4. run_fl: the main path, `repro_torch.fl.run_fl` for FEMNIST on gaia
   over the multigraph, two cycles (30 rounds) at full width on the
   card. Launch counts are zeroed just before and read just after; the
   kernel must have run once per round and the losses must be finite.
   A second run aggregating with the plain version must give the same
   losses bit for bit (deterministic algorithms are on for both runs);
5. cycle: one steady-state cycle (15 rounds) timed per aggregator, in
   turns, and a profile of where its device time goes: kernel time by
   name, and the device's idle share against the unprofiled cycle time.

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

# Data-sheet HBM rates (bytes/s) and non-tensor fp32 peaks (flop/s).
_CARD_RATES = (("H200", 4.8e12, 67e12), ("H100 NVL", 3.9e12, 60e12),
               ("H100 PCIe", 2.0e12, 51e12), ("H100", 3.35e12, 67e12))


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def card_rates(name: str) -> tuple[float, float, str]:
    for key, bw, flops in _CARD_RATES:
        if key in name:
            return bw, flops, key
    return 3.35e12, 67e12, "H100 SXM (assumed)"


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


def phase_edge_aggregate(torch, ctx):
    import numpy as np
    from repro_torch.core.delay import FEMNIST
    from repro_torch.fl.dpasgd import make_round_schedule
    from repro_torch.kernels.gossip_combine import ops
    from repro_torch.kernels.gossip_combine.ref import edge_aggregate_ref
    from repro_torch.networks.registry import get_network

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    plan, _ = make_round_schedule("multigraph", get_network("gaia"), FEMNIST)
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
    for name, args in (("main", main), ("odd_isolated", odd),
                       ("no_edges", no_edges)):
        got = ops.edge_aggregate(*args)
        want = edge_aggregate_ref(*args)
        torch.cuda.synchronize()
        errs[name] = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"edge_aggregate {name}: kernel and plain "
                                 f"version differ, max |diff| {errs[name]}")
    if not torch.equal(ops.edge_aggregate(*odd)[0], odd[4][0] * odd[0][0]):
        raise AssertionError("isolated destination is not diag*w")

    e2 = len(plan.dst)
    w, buf, coeffs, rp, diag = main
    cmat = torch.zeros((n, e2), device=dev)
    cmat[torch.as_tensor(plan.dst[order], device=dev).long(),
         torch.arange(e2, device=dev)] = coeffs
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    lib_out = torch.addmm(diag[:, None] * w, cmat, buf)
    kernel_ms = cuda_ms(torch, lambda: ops.edge_aggregate(*main), 50)
    plain_ms = cuda_ms(torch, lambda: edge_aggregate_ref(*main), 10)
    library_ms = cuda_ms(
        torch, lambda: torch.addmm(diag[:, None] * w, cmat, buf), 50)
    torch.backends.cuda.matmul.allow_tf32 = prev_tf32

    bw, fp32, rate_key = card_rates(ctx["kind"])
    nbytes = (e2 + 2 * n) * t * 4 + e2 * 4 + (n + 1) * 4 + n * 4
    flops = (2 * e2 + 2 * n) * t
    bytes_ms, ops_ms = nbytes / bw * 1e3, flops / fp32 * 1e3
    ctx["edge_aggregate"] = dict(
        max_abs_err=max(errs.values()), ms=kernel_ms, plain_ms=plain_ms,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=library_ms)
    emit(phase="edge_aggregate", ok=True, shape=dict(n=n, e2=e2, t=t),
         max_abs_diff=errs, kernel_ms=kernel_ms, plain_ms=plain_ms,
         library_ms=library_ms,
         library_max_abs_diff=float((lib_out - ops.edge_aggregate(*main))
                                    .abs().max()),
         bound_ms=max(bytes_ms, ops_ms), bytes=nbytes, flops=flops,
         rates=dict(card=rate_key, hbm_bytes_per_s=bw, fp32_flop_per_s=fp32),
         achieved_gb_per_s=nbytes / kernel_ms / 1e6)


def phase_run_fl(torch, ctx):
    from repro_torch.fl import FLConfig, run_fl, train
    from repro_torch.kernels.gossip_combine import ops

    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.benchmark = False
    cfg = FLConfig(dataset="femnist", network="gaia", topology="multigraph",
                   rounds=ROUNDS, eval_every=15)
    ops.edge_aggregate.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_fl(cfg)                      # the card is the default device
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.edge_aggregate.launches
    ctx["launches"] = {"edge_aggregate": launches}
    if launches != ROUNDS:
        raise AssertionError(f"edge_aggregate launched {launches} times in "
                             f"{ROUNDS} rounds")
    if not all(math.isfinite(x) for x in res.round_losses):
        raise AssertionError(f"non-finite losses {res.round_losses}")

    t0 = time.perf_counter()
    ref = train(cfg, device="cuda", aggregator="reference")
    torch.cuda.synchronize()
    wall_ref = time.perf_counter() - t0
    if ref.round_losses != res.round_losses or ref.eval_accs != res.eval_accs:
        raise AssertionError("kernel and plain aggregation diverged: "
                             f"{res.round_losses} vs {ref.round_losses}")
    emit(phase="run_fl", ok=True, rounds=ROUNDS, launches=launches,
         wall_s=wall, ms_per_round=wall / ROUNDS * 1e3,
         wall_s_reference_aggregator=wall_ref,
         mean_cycle_ms=res.mean_cycle_ms, total_time_s=res.total_time_s,
         round_losses=res.round_losses, eval_rounds=res.eval_rounds,
         eval_accs=res.eval_accs, reference_aggregator_equal=True)


def phase_cycle(torch, ctx):
    """Steady-state cycle time per aggregator, and a device-time profile
    of one cycle (sums by kernel name)."""
    import numpy as np
    from repro_torch.core.delay import FEMNIST
    from repro_torch.data.synthetic import make_federated_dataset
    from repro_torch.fl import flat as flatmod, runtime as flrt
    from repro_torch.fl.dpasgd import make_round_schedule
    from repro_torch.models.small import FEMNIST_CNN
    from repro_torch.networks.registry import get_network
    from repro_torch.optim import flat_sgd

    dev = torch.device("cuda")
    net = get_network("gaia")
    n = net.num_silos
    plan, _ = make_round_schedule("multigraph", net, FEMNIST)
    params = FEMNIST_CNN.init(torch.Generator().manual_seed(0))
    rt = flrt.make_flat_runtime(plan, params, n)
    opt = flat_sgd(0.05)
    data = make_federated_dataset("femnist", n, samples_per_silo=128)
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
    for agg in ("kernel", "reference", "kernel", "reference"):
        cycle = flrt.make_cycle_fn(rt, loss_fn=FEMNIST_CNN.loss, opt=opt,
                                   aggregator=agg)
        state = flrt.init_flat_state(w0, opt, rt)
        times.setdefault(agg, []).append(cuda_ms(
            torch, lambda: cycle(state, batches, *plan_t), 5, warmup=1))
    cycle = flrt.make_cycle_fn(rt, loss_fn=FEMNIST_CNN.loss, opt=opt)
    state = flrt.init_flat_state(w0, opt, rt)
    cycle(state, batches, *plan_t)
    torch.cuda.synchronize()
    profile = None
    try:
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
        cycle_ms = min(times["kernel"])
        profile = dict(
            device_busy_ms=busy_ms, kernel_launches=sum(x[2] for x in rows),
            edge_aggregate_ms=sum(us for us, k, _ in rows
                                  if "edge_aggregate" in k) / 1e3,
            idle_share=max(0.0, 1 - busy_ms / cycle_ms),
            top=[dict(kernel=k[:100], device_ms=us / 1e3, calls=c)
                 for us, k, c in rows[:12]])
    except Exception as exc:  # the profiler is untried on this machine
        profile = dict(error=f"{type(exc).__name__}: {exc}")
    emit(phase="cycle", ok=True, rounds=r, batch_size=32,
         cycle_ms=times, round_ms={k: [x / r for x in v]
                                   for k, v in times.items()},
         profile=profile)


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    ctx: dict = {}
    for phase in (phase_device, phase_build, phase_edge_aggregate,
                  phase_run_fl, phase_cycle):
        try:
            phase(torch, ctx)
        except Exception as exc:
            emit(phase=phase.__name__[len("phase_"):], ok=False,
                 error=f"{type(exc).__name__}: {exc}")
            traceback.print_exc()
            return 1
    ea = ctx["edge_aggregate"]
    print(json.dumps({"kernels": [dict(
        name="edge_aggregate", route="cuda",
        source="src/repro_torch/csrc/edge_aggregate.cu",
        replaces="src/repro/kernels/gossip_combine/kernel.py:114",
        launches=ctx["launches"]["edge_aggregate"], **ea)]}))
    print(ctx["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": ctx["kind"], "count": ctx["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
