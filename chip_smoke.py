#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card, as torch and nvidia-smi name it;
2. build: nvcc builds every CUDA kernel from src/repro_torch/csrc, one
   process per source, all at once;
3. edge_aggregate: the CSR kernel (`csrc/edge_aggregate.cu`) unfused
   (`ops.edge_aggregate`) against its plain PyTorch version on an
   odd-width case with an isolated destination and with no edges; then
   fused (`ops.refresh_aggregate`: the strong edges' buffer refresh and
   the aggregation in one launch) against its plain version, outputs
   and refreshed buffers bit for bit, at the main path's shape (N=11
   silos, 2E=22 directed edges of the gaia multigraph, T=1,280,478
   FEMNIST CNN parameters) and the slice's other shapes (EA_SHAPES: the
   Sent140 LSTM's T=5,070,882 and the iNaturalist ResNet's T=11,685,170
   over the multigraph, the ResNet on MATCHA's complete base graph,
   2E=110, and on the star, hub in-degree 10; FEMNIST's T over the
   multigraph of the generated 64-silo WAN, N=64, 2E=128), and grouped
   as the runtimes launch it: FEMNIST's CNN leaf by leaf (the legacy
   runtime), reduced mamba2-370m's 12 leaves and its largest leaf on 4
   gaia silos (`run_reduced_fl`), and FEMNIST's rows on 4 stacked
   shards, pad rows and pad edges' buffers NaN (the mesh cycle, held
   against the flat call too). Times the fused launch, the same run's
   unfused path (`torch.where` of the refresh, then the CSR kernel),
   the plain version and the library yardstick (the same `where`, then
   `torch.addmm` over the dense coefficient matrix, TF32 off; the port
   never calls it) beside the least time the card could take for this
   round's strong mask, at every shape; each of the four in a replayed
   CUDA graph over input copies out of L2 (the `kernels` rows) and by
   events around eager calls (`*_eager_ms`); the grouped calls also one
   segment a launch;
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
   of the wgmma route at hd 64, 128 and 256 (groups of 3 and 7, S under
   one key tile, ragged tiles, window and prefix edges across tiles,
   paligemma's prefix over four 64-key tiles, q sliced from a fused qkv
   projection), an hd-256 q with rows off the 16-byte grid (the CUDA
   cores), the yi-9b prefill shape (B=4, S=2048, Hq=32, Hkv=4, hd=128,
   bf16, causal) and paligemma-3b's (B=4, S=2048, Hq=8, Hkv=1, hd=256,
   prefix 256), within the reference tests' tolerances (5e-4 f32, 2e-2
   bf16), each case on the route the rule gives it; at both prefill
   shapes also against the plain version run in fp32, per row
   (FP32_ROW_REL_TOL); ptxas's registers and spills of the wgmma kernels
   at hd 64, 128 and 256 (a spill fails the phase); times the kernel,
   the plain version and `F.scaled_dot_product_attention` (a yardstick
   the port never calls; at paligemma's shape with the same boolean
   mask) beside the bound, at the yi-9b shape, at zamba2's (B=4,
   S=2048, Hq=Hkv=32, hd=64) and at paligemma's (the bound over the
   pairs the mask keeps; its own `kernels` row);
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
9b. sharded: the sharded LLM program on a one-rank NCCL (1, 1) ("data",
   "model") DeviceMesh, yi-9b's weights as DTensors under the
   production specs: prefill at the shape of 8 with the activation
   anchors, 48 `flash_attention` launches all on wgmma (each on the
   rank's head shard), logits bit-equal to the unsharded step; decode of
   8 slots, 16 prompt and 8 greedy tokens, 48 `decode_attention`
   launches a step, tokens and logits bit-equal; both paths timed beside
   the unsharded ones (DTensor's host cost); the kv_seq_shard cache
   layout refused by the kernel route; its launches are two more
   `kernels` rows;
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
15. serving: the slot engine (`repro_torch.serving.ServingEngine`),
   its decode step captured as one CUDA graph. (a) yi-9b at full width
   and depth, bf16, 8 slots, max_seq 2048: 16 requests (prompts of
   DECODE_PROMPTS twice over, 32 greedy tokens each; the second eight
   wait and take freed slots, zeroed in place under the live graph)
   through an eager engine (`cuda_graph=False`) and a captured one:
   every request's tokens equal, the logits' largest difference at
   three steps, one capture, 48 `decode_attention` kernels a replay
   (profiler), the captured step replayed once more against the step
   with the same positions read on the host, on a copy of the live
   caches (logits and caches bit-equal), one request alone after a
   `reset()` giving its tokens in the batch; ms a step of each (steady
   steps, the sampled tokens' copy to the host included), the device's
   ms and idle share a step, tokens/s, and the kernel on the engine's live caches against
   its plain version and timed there. (b) zamba2-1.2b, 8 requests,
   the same, 6 kernels a replay. (c) an FL checkpoint of reduced yi-9b
   on gaia's 11 silos (rows around one seeded `init_params`, the
   trainer's metadata, in a temporary directory) deployed by
   `RegionalFleet.from_checkpoint` on the card and on the CPU,
   `sweep_loads` at 20, 60 and 120 req/s (1 s, 10 ms steps): the
   summaries equal dict for dict, loads nested, p99 monotone, one
   capture per region engine, the tokens of card and CPU compared,
   wall seconds per load; the kernel at the fleet's shape (fp32, hd
   32, B 4, S 64) against its plain version. (d) `python -m
   repro_torch.serving --skip-train` on that checkpoint (exit 0),
   `python -m repro_torch.obs validate` of its bench and trace (exit
   0), and the CLI with --mesh 2 --lora-rank 4 (trains LoRA deltas on
   two stacked shards, then serves its `lora_delta` checkpoint: exit 0);
16. llm_families (no deterministic algorithms): granite-moe-1b-a400m,
   paligemma-3b, musicgen-large and gemma3-27b at full width and depth,
   bf16, random weights drawn on the card from seed 0, one model at a
   time. `make_prefill_step(impl="kernel")` on 4 sequences of 2048
   positions (paligemma's 256 and musicgen's 64 prefix positions
   included, from `synthetic_prefix`): one `flash_attention` launch per
   attention layer (24, 18, 48, 62; gemma3's local layers with window
   1024, its global ones with none), every bf16 one on the wgmma route
   (`launches_by_route`; paligemma's hd 256 too), and last-position
   logits within FAMILY_LOGITS_REL_TOL of `impl="reference"`
   (granite-moe's bf16 forward is chaotic on random weights: it is also
   held in fp32, prefill and decode, on the CUDA cores); ms per prefill
   and tokens/s. The kernel at the family's prefill shape against its
   plain version, timed beside it, SDPA with the same mask and the bound.
   `make_serve_step` on 8 slots fed prompts of 2..16 tokens token by
   token, then 32 greedy tokens: one `decode_attention` launch per layer
   a step, logits within the same limit of a `decode_step(impl=
   "reference")` run fed the same tokens; ms a step; the decode kernel
   on the run's own caches against its plain version and timed there;
17. llm_train: `make_train_step` at full width for mamba2-370m and
   granite-moe-1b (bf16 parameters, fp32 AdamW, remat, ce_block 256, 4 x
   2048 tokens, five steps on one repeated batch): losses finite and
   falling from step 1 to step 5, the first within 1e-3 relative of
   `loss_fn`; ms a step, tokens/s, `max_memory_allocated` and a profile
   of one step. `make_fl_train_step` on 2 silos of mamba2-370m (2 x
   2048 a silo), a round without and one with the consensus from the
   same state under deterministic algorithms: the gossiped parameters
   equal `torch.einsum` of the consensus and the local updates bit for
   bit. `run_reduced_fl` at the CLI's defaults (mamba2-370m reduced, 4
   gaia silos, the multigraph, 30 rounds): one `edge_aggregate` launch
   a round for all leaves, finite losses, the simulated fields equal to
   the same run's with device="cpu". `python -m repro_torch.serving`
   with only --ckpt-dir and --bench (trains, then serves): exit 0, and
   `python -m repro_torch.obs validate --bench` accepts its rows;
18. gossip_combine: the kernel against its plain version, bit for bit
   (`torch.equal`), on the reference kernel tests' cases, T = 65537,
   T = 0, bf16, and K = 1..6 at odd T with rows off the 16-byte grid,
   and at the ring's shape (3, 368,226,304) fp32, where it is timed
   beside the plain version, a cuBLAS GEMV (`coeffs @ weights`, a
   yardstick the port never calls) and the bound;
19. ring_gossip: `launch/fl8` on `StackedSilos(8)`, eight mamba2-370m
   replicas at full width and depth (bf16, one seeded generator per
   silo): one round per state (overlay, half, isolated) with its checks
   (8 `gossip_combine` launches a round; 2, 1 and 0 replicas per silo
   across the silo axis; fresh buffers bit-equal to the rolls; kernel
   path bit-equal to the elementwise path; overlay against
   `gossip_dense` with the ring's Metropolis matrix, within one bf16 ulp
   of sum_j |A_ij w_j|; isolated reads only the stale buffers), then
   RING_ROUNDS timed rounds per state (ms per round, bytes per round,
   the kernel's share, peak memory) and a profile of an overlay round;
20. run_fl_surface (this phase and those after it run with the
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
   momentum 0 and 0.9 (bit-equal; the legacy round launches
   `edge_aggregate` once a round for all leaves), the "dense"
   aggregator against the kernel on the ring (bit-equal), FEMNIST on
   wan64 as in 4, and the
   cycle with metrics against without, in alternating turns; the wall
   time of a whole run per round (set-up included) for plain, hooked,
   hooked, plain runs, the hooked run's steady chunk from its trace, the
   checkpoint's write time and bytes;
21. fl_mesh (deterministic algorithms on for (a) and (e)): the
   mesh-sharded runtime and LoRA deltas. (a) `run_fl` for FEMNIST on
   gaia at full width (batch 32, momentum 0.9, 30 rounds) on the flat
   runtime and on 1, 2, 4 and 8 stacked shards (`mesh=D`) with both
   gossip backends: every mesh run bit-equal to the flat run (losses,
   accuracies, final rows, buffers and momentum), its simulated clock
   equal, one `edge_aggregate` launch a round for any D; the
   gather-and-aggregate stage alone bit-equal on identical random
   inputs with NaN in every
   pad row and pad edge buffer; silo 0's gradient by silos batched; ms a
   round, `fabric_bytes` and the shard axis's bytes a round of each.
   (e) `run_fl(mesh="auto")` in a one-rank NCCL process group
   (`GroupShards` with CUDA tensors), bit-equal to one stacked shard.
   (c) `run_reduced_fl(mesh=2,
   lora_rank=4)` at the CLI's defaults on the card (30 launches) and on
   the host from the same start: losses within LORA_LOSS_RTOL; its
   `lora_delta` checkpoint served by `RegionalFleet` on the card, each
   region's variant `apply_delta` of its mean delta bit for bit, the
   served tokens equal to those of a `full` twin of those variants. (d)
   LoRA rank 8 over mamba2-370m at full width and depth on 2 stacked
   shards, 4 gaia silos, a 4-round warm-up call, then the whole
   multigraph cycle (60 rounds) in one call, timed:
   T_lora, ms a round, peak memory, finite losses;
22. launch_analysis (no kernel launched): the launch analysis tools
   against the card's own readings. (a) Every prefill and train step
   timed above against its analytic bound on this card
   (`repro_torch.launch.roofline.bound_ms`: the reference's FLOP and
   byte model at the data sheet's rates): none may be faster. (b) The
   dry run's peak live bytes of `llm_train`'s two steps, traced on fake
   tensors by the host workers, against their `max_memory_allocated`,
   within DRY_PEAK_BAND. (c) Every `fabric_bytes` reading of `fl_mesh`
   equal to `fl_mesh_fabric_bytes` of `fl_mesh_report(network="gaia")`
   at FEMNIST's width. (d) The dry run's CLI (DRYRUN_CLI, run by the
   host workers) and the roofline CLI on its reports, each exiting 0;
22b. sharded_host (no kernel launched): the host workers' sharded dry
   run (SHARDED_DRYRUN_CLI: yi-9b x train_4k on a fake (16, 16) world,
   one layer) exits 0 with collectives counted, and `fl8`'s dry states
   order their pod-axis bytes overlay > half > isolated = 0;
23. run_fl_models (run last with the next phase): the same as 4 for the
   Sent140 LSTM and the iNaturalist ResNet (gaia, multigraph, batch 32,
   lr 0.05, 30 rounds), then one steady-state cycle of each, timed and
   profiled as in 5;
24. topologies: FEMNIST, 6 rounds per case, each run as in 4 (one launch
   a round, the plain aggregation bit-equal): star, mst, dmbst, ring,
   matcha and matcha_plus on gaia; the multigraph on geant, exodus and
   ebone (overlays from the blossom matching); the multigraph with
   Algorithm 1's multiplicity vector (which must train exactly as the
   default run) and another; two silos removed, randomly and by
   inefficiency;
25. design_loop (run last, deterministic algorithms on): the
   time-to-accuracy evaluator and the paper's tables.
   `evaluate_frontier` on gaia / femnist at its defaults (60 rounds,
   batch 16, 64 samples a silo) over Algorithm 1's t = 5 vector, the
   all-ones vector and the t = 3 vector on the same overlay: exactly
   180 `edge_aggregate` launches, each candidate bit-equal to
   `evaluate_design` (`run_fl` of its vector), the first also to
   `train(cfg, aggregator="reference")`; each candidate's TTA row and
   host ms a round. `attach_tta` on the gaia / femnist multigraph cell
   (40 rounds) against a direct `evaluate_design`. The paper's whole
   grid (`run_sweep(SweepConfig())`, 105 cells at 6,400 rounds, host
   numpy) with Tables 1 and 3 and its host seconds, and
   `consistency_check` on the `--quick` config. `scenario_cycle_times`
   of the gaia multigraph under nominal (bit-equal to `cycle_times`),
   drift, diurnal, flash and churn (finite, at or above the nominal
   total). One drift trace by `python -m repro_torch.obs trace`, checked
   by `validate`. The tables' and scenarios' times and `tta_s` are
   simulated seconds of the paper's network model, not the card's;
26. design_search (last, deterministic algorithms on): the design search
   and the fault controller. (a) The paper's whole grid (105 cells, 15
   on the recurrence axis, 6,400 rounds) by `TimingGrid.reports` on the
   device grid (`backend="torch"`) and on the host, equal report for
   report, with each engine's seconds and the device grid's operations
   a round (the profiler's count at two round counts); (b)
   `CandidateScorer` over gaia / femnist's ring overlay at 6,400 rounds
   on the card and on the host (in a host worker) for 16, 256 and 4,096
   seeded random candidates, the scores bit-equal, with candidates per
   second of each; (c)
   `population_search(gaia, femnist)` on both backends at the search
   CLI's --quick sizes (800 rounds, 6 iterations, pop 12, 4
   generations), equal rows and pools, seconds of each; (d)
   `ControllerHarness(ControllerConfig())` at its defaults (48 rounds,
   re-planning every 12, batch 16, 64 samples a silo, the full CNN):
   nominal and churn, static and adaptive, exactly 192 `edge_aggregate`
   launches and one cycle function built; nominal static == adaptive
   with no swap and == `evaluate_design`; churn's swaps and its
   adaptive run's `tta_s` and total below the static run's; the
   adaptive churn run again with the plain aggregation, bit-equal; host
   ms a round of each run; one traced run checked by `validate_trace`;
   (e) `python -m repro_torch.design.search --networks gaia --workloads
   femnist --quick`, cycle and tta objectives, exit 0.

`python3 chip_smoke.py --decode-bench DIR` instead times only the
decode kernel of the port under DIR/src at the three decode shapes
(`decode_bench`), `--ssd-bench DIR` only the SSD scan at the two
prefill shapes (`ssd_bench`), and `--cycle-bench DIR` only the FEMNIST
cycle (`cycle_bench`), so that two commits compare in one call;
`--profiler-bench SECONDS` samples how many short kernels' records the
profiler keeps, in a bare and a padded window, as the process ages.

Host work that needs no card runs beside the card phases, from the end
of phase HOST_WORK_AFTER, in worker processes of one thread each
(`start_host_work`): the dry runs and the dryrun CLI of phase 22, the
sharded dry runs of phase 22b and the host scorer of phase 26 (b); the
phases that read it wait for it. The
profiles are summed from the profiler's raw records (`device_averages`,
`host_averages`: what `key_averages` gives, without the event tree that
costs minutes of host time). Every JSON line carries `t_s`, the seconds
since the start, and a `timeline` line after the last phase gives each
phase's wall seconds and the seconds spent waiting for host work.

Then a `{"kernels": [...]}` line (every row's `route` is "cuda"; the
flash_attention rows of paligemma and the families name the kernel's
own route, wgmma or CUDA cores, as `kernel_route`), the card's name and
power limit as nvidia-smi gives them, and last `{"ok": true, "device":
{...}}`. Any
failed phase prints its error and exits 1 with no result. Without a CUDA
device, or without the repository's src/ beside it, it exits non-zero.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import NamedTuple

# cuBLAS needs a fixed workspace for deterministic results (set before
# the first CUDA call).
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
MAIN_SHAPE = dict(n=11, t=1_280_478)      # gaia silos, FEMNIST CNN size
ROUNDS = 30


def emit(**fields) -> None:
    """One JSON line of ``fields`` and `t_s`, the seconds since the script
    started."""
    print(json.dumps(dict(fields, t_s=time.perf_counter() - T_START)),
          flush=True)


def card_rates(name: str) -> tuple[float, float, str]:
    """(HBM bytes/s, fp32 flop/s, name of the row used): the data-sheet
    table of `repro_torch.launch.roofline.CARD_RATES`, which the roofline
    prices with too."""
    from repro_torch.launch import roofline
    return roofline.card_rates(name)


def bf16_peak(name: str) -> float:
    """Dense bf16 tensor-core flop/s of the card (the same table)."""
    from repro_torch.launch import roofline
    return roofline.bf16_peak(name)


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


#: Host seconds of sleep that pad every profiler window on both sides of
#: its work. The profiler drops device records as the process ages: in
#: one process on an H100, a bare window of 20 back-to-back short kernels
#: read 20, 16, 13, 9, 5, 2 and then 0 of them over five minutes, the same
#: window padded by 0.2 s all 20 every time (`--profiler-bench 300`,
#: PERF.md).
PROFILE_PAD_S = 0.2


@contextlib.contextmanager
def profiled(torch):
    """`torch.profiler.profile` of the host and the card around the body,
    its window padded by PROFILE_PAD_S before the body and after the
    body's work has finished on the card."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)


class Avg(NamedTuple):
    """One name's records in a profile, summed as `key_averages` sums
    them: times in microseconds."""
    key: str
    count: int
    self_device_time_total: float = 0.0
    self_cpu_time_total: float = 0.0


def _records(prof, device_type):
    """(name, start, end, thread) of each of the profile's records of
    ``device_type`` that `key_averages` counts (utility, hidden and
    asynchronous records dropped; times in microseconds), read from
    the raw kineto results: `key_averages` first builds the profiler's
    event tree in Python, record by record, minutes of host time for a
    window of tens of thousands of kernels."""
    from torch.autograd.profiler_util import _filter_name

    results = prof.profiler.kineto_results
    zero = results.trace_start_ns()
    for ev in results.events():
        if (ev.device_type() != device_type or _filter_name(ev.name())
                or getattr(ev, "is_hidden_event", lambda: False)()
                or ev.is_async()
                or ev.start_thread_id() != ev.end_thread_id()):
            continue
        name = ev.name()
        yield (("ProfilerStep*" if name.startswith("ProfilerStep#")
                else name), (ev.start_ns() - zero) / 1e3,
               (ev.end_ns() - zero) / 1e3, ev.start_thread_id())


def device_averages(prof) -> list:
    """The profile's device records by name: count and device time, as
    `key_averages` gives its CUDA rows."""
    from torch.autograd import DeviceType

    sums: dict = {}
    for key, start, end, _ in _records(prof, DeviceType.CUDA):
        us, n = sums.get(key, (0.0, 0))
        sums[key] = (us + end - start, n + 1)
    return [Avg(key, n, self_device_time_total=us)
            for key, (us, n) in sums.items()]


def host_averages(prof) -> list:
    """The profile's host records by name: count and CPU time of their
    own (less that of the records nested in them on the same thread), as
    `key_averages` gives its CPU rows, which also fold a record into its
    parent of the same name when it is the parent's only child."""
    from torch.autograd import DeviceType

    threads: dict = {}
    for key, start, end, thread in _records(prof, DeviceType.CPU):
        threads.setdefault(thread, []).append([start, end, key, []])
    sums: dict = {}
    for recs in threads.values():
        recs.sort(key=lambda r: (r[0], -r[1]))
        stack: list = []        # [start, end, key, children]
        for rec in recs:
            while stack and (rec[0] >= stack[-1][1]
                             or rec[1] > stack[-1][1]):
                stack.pop()
            if stack:
                stack[-1][3].append(rec)
            stack.append(rec)
        kept = {id(r): r for r in recs}
        for rec in recs:
            while (id(rec) in kept and len(rec[3]) == 1
                   and rec[3][0][2] == rec[2]):
                kept.pop(id(rec[3][0]))
                rec[3] = rec[3][0][3]
        for start, end, key, children in kept.values():
            us, n = sums.get(key, (0.0, 0))
            sums[key] = (us + end - start - sum(c[1] - c[0] for c in children),
                         n + 1)
    return [Avg(key, n, self_cpu_time_total=us)
            for key, (us, n) in sums.items()]


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


#: The fused kernel's one-segment shapes, as the flat cycle calls it:
#: (network, workload, topology, T). On gaia, FEMNIST's CNN (the main
#: path), the LSTM and the ResNet over the multigraph (2E = 22), the
#: ResNet on MATCHA's complete base graph (2E = 110, in-degree 10, many
#: coefficients 0 in a round) and on the star (hub in-degree 10, leaves
#: 1); FEMNIST over the multigraph of the generated 64-silo WAN (N = 64,
#: 2E = 128). Round 1 of each plan's cycle (its strong mask and weights).
EA_SHAPES = {
    "femnist_multigraph": ("gaia", "femnist", "multigraph", MAIN_SHAPE["t"]),
    "lstm_multigraph": ("gaia", "sentiment140", "multigraph", 5_070_882),
    "resnet_multigraph": ("gaia", "inaturalist", "multigraph", 11_685_170),
    "resnet_matcha": ("gaia", "inaturalist", "matcha", 11_685_170),
    "resnet_star": ("gaia", "inaturalist", "star", 11_685_170),
    "femnist_wan64": ("wan64", "femnist", "multigraph", MAIN_SHAPE["t"])}
#: timed calls of the fused kernel at a shape (the main one: 50)
EA_ITERS = 20
#: the fused kernel's graph-replayed time cycles input copies of at
#: least this many bytes together: twice the H100's 50 MB L2
EA_COLD_BYTES = 100_000_000


def _on(torch, a, dtype=None):
    return torch.as_tensor(a, dtype=dtype, device="cuda")


def _flat_segment(torch, plan, k: int, n: int, t: int, gen):
    """Round k of ``plan`` at width t as the flat cycle hands it to the
    fused kernel: rows and dst-sorted buffers drawn on the card, and the
    edges' destinations."""
    from repro_torch.kernels.gossip_combine import ops
    from repro_torch.kernels.gossip_combine.ref import Segment

    order, rp = ops.csr_sort(plan.dst, n)
    seg = Segment(torch.randn((n, t), generator=gen, device="cuda"),
                  torch.randn((len(order), t), generator=gen, device="cuda"),
                  _on(torch, plan.coeffs[k][order]), _on(torch, rp),
                  _on(torch, plan.diag[k]),
                  src=_on(torch, plan.src[order], torch.int32),
                  strong=_on(torch, plan.strong[k][order]))
    return seg, plan.dst[order]


def _leaf_segments(torch, plan, k: int, n: int, sizes, gen):
    """Round k of ``plan`` as `fl_round_step` hands it over: one segment a
    leaf of ``sizes`` elements, the buffers in the plan's edge order
    (``edge_row``), the edge tables shared."""
    from repro_torch.kernels.gossip_combine import ops
    from repro_torch.kernels.gossip_combine.ref import Segment

    order, rp = ops.csr_sort(plan.dst, n)
    shared = dict(coeffs=_on(torch, plan.coeffs[k][order]),
                  row_ptr=_on(torch, rp), diag=_on(torch, plan.diag[k]),
                  src=_on(torch, plan.src[order], torch.int32),
                  strong=_on(torch, plan.strong[k][order]),
                  edge_row=_on(torch, order, torch.int32))
    segs = [Segment(w=torch.randn((n, t), generator=gen, device="cuda"),
                    buf=torch.randn((len(order), t), generator=gen,
                                    device="cuda"), **shared)
            for t in sizes]
    return segs, [plan.dst[order]] * len(segs)


def _same(torch, a, b) -> bool:
    """Equal, NaN where NaN."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        torch.where(nan, 0.0, a), torch.where(nan, 0.0, b))


def _mesh_segments(torch, plan, k: int, n: int, t: int, d: int, gen):
    """Round k of ``plan`` as the mesh cycle on ``d`` stacked shards hands
    it to the fused kernel: one segment a shard's padded block, its fresh
    rows gathered as the cycle's CSR gather gives them, NaN in the pad
    rows and pad edges' buffer rows (never read or written). Each shard's
    real rows and edge buffers are held against the flat call on the same
    rows, bit for bit."""
    import numpy as np
    from repro_torch.fl import mesh as flmesh
    from repro_torch.fl import runtime as flrt
    from repro_torch.kernels.gossip_combine import ops
    from repro_torch.kernels.gossip_combine.ref import Segment

    rt = flrt.make_flat_runtime(plan, {"w": torch.empty(t, device="meta")},
                                n)
    mrt = flmesh.make_mesh_runtime(rt, d, device="cuda")
    per, e_per = mrt.per_rows, mrt.edges_per_shard
    rows = mrt.mspec.rows_padded
    flat, _ = _flat_segment(torch, plan, k, n, t, gen)
    nan = torch.full((1, t), float("nan"), device="cuda")
    w = torch.cat([flat.w, nan.expand(rows - n, t)])
    perm = _on(torch, mrt.edge_perm)
    buf = torch.cat([flat.buf, nan])[perm]
    coeffs = torch.cat([flat.coeffs, flat.coeffs.new_zeros(1)])[perm]
    strong = torch.cat([flat.strong, flat.strong.new_zeros(1)])[perm]
    diag = torch.cat([flat.diag, flat.diag.new_ones(rows - n)])
    segs = [Segment(w[p * per:(p + 1) * per],
                    buf[p * e_per:(p + 1) * e_per],
                    coeffs[p * e_per:(p + 1) * e_per],
                    _on(torch, mrt.shard_row_ptr(p)),
                    diag[p * per:(p + 1) * per],
                    fresh=w[_on(torch, mrt.src_global[p]).long()],
                    strong=strong[p * e_per:(p + 1) * e_per])
            for p in range(d)]
    flat_buf = flat.buf.clone()
    want, = ops.refresh_aggregate([flat._replace(buf=flat_buf)])
    trial = [s._replace(buf=s.buf.clone()) for s in segs]
    outs = torch.cat(ops.refresh_aggregate(trial))[:n]
    real = np.flatnonzero(mrt.edge_perm < len(plan.dst))
    bufs = torch.cat([s.buf for s in trial])[_on(torch, real)]
    if not (torch.equal(outs, want) and torch.equal(
            bufs, flat_buf[_on(torch, mrt.edge_perm[real])])):
        raise AssertionError(f"mesh D={d}: the shards' fused outputs or "
                             "buffers differ from the flat call's")
    dst = [mrt.dst_local[p, :mrt.edge_counts[p]] for p in range(d)]
    return segs, dst, dict(shards=d, per=per, e_per=e_per,
                           real_edges=mrt.edge_counts.tolist())


def _fused_work(segs) -> tuple[int, int]:
    """(bytes, flops) the fused call needs on these inputs: each row of w
    read once, each weak buffer row read once, each strong buffer row
    written once, each strong edge's fresh row read once where fresh is
    not w (a row of w is read once either way), the output rows written
    once, and the edge tables read once; two flops per edge element and
    per row element of diag*w. The strong masks are this run's."""
    nbytes = flops = 0
    for s in segs:
        n, t = s.w.shape
        rp = s.row_ptr.tolist()
        e = rp[-1] - rp[0]
        strong = int(s.strong[rp[0]:rp[-1]].sum()) if s.strong is not None \
            else 0
        fresh = strong if s.fresh is not None else 0
        tables = 4 * (e + 2 * n + 1) + e * (
            4 * (s.src is not None) + (s.strong is not None)
            + 4 * (s.edge_row is not None))
        nbytes += (2 * n + e + fresh) * t * 4 + tables
        flops += 2 * (e + n) * t
    return nbytes, flops


def _time_fused(torch, ctx, segs, dsts, iters: int) -> dict:
    """The fused kernel's one call over ``segs`` against its plain version
    (outputs and refreshed buffers, NaN where NaN), then timed. Every
    ``*_ms`` of the row is device time per call in a replayed CUDA graph
    (`graph_ms`: the host's launch rate, which the small shapes would
    measure otherwise, stays out) cycling copies of the inputs that
    together pass EA_COLD_BYTES, so that each call finds its inputs out
    of L2: ``ms`` the fused kernel; ``where_edge_aggregate_ms`` the same
    run's unfused path (`torch.where` of the refresh, then the CSR
    kernel, segment by segment: what the runtimes did before);
    ``plain_ms`` the plain version's device work
    (`prepare_refresh_aggregate`, its host reads made before the
    capture); ``library_ms`` the library yardstick (the same `where`,
    then `torch.addmm` over the dense coefficient matrix, TF32 off; the
    port never calls it). Each has a ``*_eager_ms`` twin: back-to-back
    calls on one set of inputs, by events, host work included. The bound
    is `_fused_work` over the card's HBM rate and fp32 rate. NaN in
    buffer rows the call never reads is zeroed before the timing, so
    that `addmm` stays finite."""
    from repro_torch.kernels.gossip_combine import ops
    from repro_torch.kernels.gossip_combine.ref import (
        prepare_refresh_aggregate, refresh_aggregate_ref)

    plain = [s._replace(buf=s.buf.clone()) for s in segs]
    before = ops.edge_aggregate.launches
    got = ops.refresh_aggregate(segs)
    want = refresh_aggregate_ref(plain)
    torch.cuda.synchronize()
    if ops.edge_aggregate.launches != before + 1:
        raise AssertionError(f"{len(segs)} segments took "
                             f"{ops.edge_aggregate.launches - before} "
                             "launches, not one")
    err = 0.0
    for g, (a, b, s, p) in enumerate(zip(got, want, segs, plain)):
        if not (_same(torch, a, b) and _same(torch, s.buf, p.buf)):
            raise AssertionError(
                f"refresh_aggregate segment {g} of {len(segs)} (N, T = "
                f"{tuple(s.w.shape)}): kernel and plain version differ")
        err = max(err, float((a - b).nan_to_num().abs().max()))
    del got, want, plain
    for s in segs:
        for x in (s.w, s.buf, s.fresh):
            if x is not None:
                torch.nan_to_num_(x, nan=0.0)
    index = [(s.src.long() if s.src is not None else None,
              s.edge_row.long() if s.edge_row is not None else None)
             for s in segs]

    def refreshed(s, src, rows):
        fresh = s.w if s.fresh is None else s.fresh
        return torch.where(s.strong[:, None],
                           fresh if src is None else fresh[src],
                           s.buf if rows is None else s.buf[rows])

    def unfused(c):
        return [ops.edge_aggregate(s.w, refreshed(s, *ix), s.coeffs,
                                   s.row_ptr, s.diag)
                for s, ix in zip(c, index)]

    cmats = []
    for s, dst in zip(segs, dsts):
        e = len(dst)
        cm = torch.zeros((s.w.shape[0], s.coeffs.shape[0]), device="cuda")
        cm[_on(torch, dst).long(), torch.arange(e, device="cuda")] = \
            s.coeffs[:e]
        cmats.append(cm)

    def library(c):
        return [torch.addmm(s.diag[:, None] * s.w, cm, refreshed(s, *ix))
                for s, cm, ix in zip(c, cmats, index)]

    bw, fp32, _ = card_rates(ctx["kind"])
    nbytes, flops = _fused_work(segs)
    # copies of the inputs, cycled, so that each call finds its own cold
    copies = [segs] + [[s._replace(**{k: getattr(s, k).clone() for k in (
        "w", "buf", "fresh") if getattr(s, k) is not None}) for s in segs]
        for _ in range(math.ceil(EA_COLD_BYTES / nbytes) - 1)]
    cold = lambda fn, replays=5: graph_ms(
        torch, [lambda c=c: fn(c) for c in copies], replays)
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    lib_diff = max(float((a - b).abs().max())
                   for a, b in zip(library(segs), ops.refresh_aggregate(segs)))
    row = dict(
        max_abs_err=err, ms=cold(ops.refresh_aggregate),
        plain_ms=graph_ms(torch, [prepare_refresh_aggregate(c)
                                  for c in copies], 1),
        library_ms=cold(library), where_edge_aggregate_ms=cold(unfused),
        eager_ms=cuda_ms(torch, lambda: ops.refresh_aggregate(segs), iters),
        plain_eager_ms=cuda_ms(torch, lambda: refresh_aggregate_ref(segs),
                               max(2, iters // 5)),
        library_eager_ms=cuda_ms(torch, lambda: library(segs), iters),
        where_edge_aggregate_eager_ms=cuda_ms(torch, lambda: unfused(segs),
                                              iters),
        library_max_abs_diff=lib_diff)
    torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    bytes_ms, ops_ms = nbytes / bw * 1e3, flops / fp32 * 1e3
    bound = max(bytes_ms, ops_ms)
    kernel_ms = row["ms"]
    row.update(bound_ms=bound,
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               faster_than_where_edge_aggregate=(
                   kernel_ms < row["where_edge_aggregate_ms"]
                   and row["eager_ms"] < row["where_edge_aggregate_eager_ms"]),
               bound_share=bound / kernel_ms, bytes=nbytes, flops=flops,
               achieved_gb_per_s=nbytes / kernel_ms / 1e6)
    if len(segs) > 1:
        row.update(
            per_segment_ms=cold(
                lambda c: [ops.refresh_aggregate([s]) for s in c]),
            per_segment_eager_ms=cuda_ms(
                torch, lambda: [ops.refresh_aggregate([s]) for s in segs],
                iters))
        row["grouped_faster"] = (
            row["ms"] < row["per_segment_ms"]
            and row["eager_ms"] < row["per_segment_eager_ms"])
    return row


def phase_edge_aggregate(torch, ctx):
    """The CSR kernel unfused (`ops.edge_aggregate`) on odd widths, an
    isolated destination and no edges; then the fused kernel
    (`ops.refresh_aggregate`) at EA_SHAPES, one segment each, and grouped
    as the runtimes call it: FEMNIST's CNN leaf by leaf (the legacy
    runtime), reduced mamba2-370m's leaves on 4 gaia silos (`run_reduced_fl`)
    and FEMNIST's rows on MESH_ROW_SHARDS stacked shards (the mesh cycle),
    each bit-equal to its plain version and timed (`_time_fused`); the
    grouped calls also one segment a launch."""
    import numpy as np
    from repro_torch.configs import get_config, reduce
    from repro_torch.core.delay import WORKLOADS
    from repro_torch.fl.dpasgd import make_round_schedule
    from repro_torch.kernels.gossip_combine import ops
    from repro_torch.kernels.gossip_combine.ref import edge_aggregate_ref
    from repro_torch.launch import train
    from repro_torch.launch.mesh import tree_leaves
    from repro_torch.models.small import SMALL_MODELS
    from repro_torch.networks.registry import get_network

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    n = MAIN_SHAPE["n"]
    # odd width, destination 0 isolated, ragged last tile; and no edges
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
    del odd, no_edges

    gen = torch.Generator(device=dev).manual_seed(1)
    shapes = {}
    for name, (network, wl, topology, width) in EA_SHAPES.items():
        net = get_network(network)
        p, _ = make_round_schedule(topology, net, WORKLOADS[wl],
                                   rounds=ROUNDS)
        k = 1 % p.num_rounds_cycle
        seg, dst_sorted = _flat_segment(torch, p, k, net.num_silos, width,
                                        gen)
        rp = seg.row_ptr.tolist()
        shapes[name] = dict(
            network=network, n=net.num_silos, e2=len(p.dst), t=width,
            max_in_degree=int(np.diff(rp).max()),
            nonzero_coeffs=int((p.coeffs[k] != 0).sum()),
            strong_edges=int(p.strong[k].sum()),
            **_time_fused(torch, ctx, [seg], [dst_sorted],
                          50 if name == "femnist_multigraph" else EA_ITERS))
        del seg
        torch.cuda.empty_cache()

    gaia = get_network("gaia")
    groups = {}
    plan, _ = make_round_schedule("multigraph", gaia, WORKLOADS["femnist"])
    cnn = [x.numel() for x in tree_leaves(SMALL_MODELS["femnist_cnn"].init(
        torch.Generator().manual_seed(0)))]
    segs, dsts = _leaf_segments(torch, plan, 1, gaia.num_silos, cnn, gen)
    groups["femnist_cnn_leaves"] = dict(
        n=gaia.num_silos, e2=len(plan.dst), leaves=len(cnn), t=cnn,
        **_time_fused(torch, ctx, segs, dsts, 50))
    cfg = train.TrainConfig()
    net4 = train._sub_network(train.get_network(cfg.network), cfg.silos)
    plan4, _ = make_round_schedule("multigraph", net4, WORKLOADS["femnist"],
                                   t=cfg.t, rounds=cfg.rounds)
    sizes = [x.numel() for x in tree_leaves(train.initial_params(
        reduce(get_config(cfg.arch)), 0, "cpu"))]
    segs, dsts = _leaf_segments(torch, plan4, 1, net4.num_silos, sizes, gen)
    largest = max(segs, key=lambda s: s.w.shape[1])
    groups["mamba2_largest_leaf"] = dict(
        n=net4.num_silos, e2=len(plan4.dst), t=max(sizes),
        **_time_fused(torch, ctx, [largest], dsts[:1], 50))
    groups["mamba2_leaves"] = dict(
        n=net4.num_silos, e2=len(plan4.dst), leaves=len(sizes), t=sizes,
        **_time_fused(torch, ctx, segs, dsts, 50))
    segs, dsts, layout = _mesh_segments(torch, plan, 1, gaia.num_silos,
                                        MAIN_SHAPE["t"], MESH_ROW_SHARDS, gen)
    groups["mesh_shards"] = dict(n=gaia.num_silos, e2=len(plan.dst),
                                 t=MAIN_SHAPE["t"], **layout,
                                 **_time_fused(torch, ctx, segs, dsts, 50))
    del segs
    torch.cuda.empty_cache()

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    main = shapes["femnist_multigraph"]
    ctx["edge_aggregate"] = {k: main[k] for k in keys}
    ctx["edge_aggregate"]["max_abs_err"] = max(
        [main["max_abs_err"], *errs.values()])
    ctx["edge_aggregate_shapes"] = shapes
    ctx["edge_aggregate_rows"] = {
        name: {k: row[k] for k in keys} for name, row in groups.items()}
    bw, fp32, rate_key = card_rates(ctx["kind"])
    emit(phase="edge_aggregate", ok=True, seconds=time.perf_counter() - t0,
         unfused_max_abs_diff=errs,
         rates=dict(card=rate_key, hbm_bytes_per_s=bw, fp32_flop_per_s=fp32),
         shapes=shapes, groups=groups, nvidia_smi=ctx["smi"])


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
    with profiled(torch) as prof:
        cycle(state, batches, *plan_t)
    # kernels only: op-level rows repeat their kernels' device time
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in device_averages(prof)
                   if ev.self_device_time_total > 0), reverse=True)
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


def _legacy_vs_flat(torch, ctx) -> dict:
    """`runtime="legacy"` against the flat runtime on the FEMNIST config,
    at momentum 0 and 0.9: losses and accuracies bit-equal (the vmapped
    convolutions copy the flat runtime's weight views into contiguous
    tensors, so cuDNN sees the legacy runtime's layouts). The legacy
    round refreshes and aggregates all its leaves in one launch of the
    fused kernel a round."""
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
        if launches != ROUNDS:
            raise AssertionError(f"the legacy runtime launched "
                                 f"edge_aggregate {launches} times in "
                                 f"{ROUNDS} rounds")
        ctx["launches"]["edge_aggregate_legacy"] = launches
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
    legacy = _legacy_vs_flat(torch, ctx)
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


# fl_mesh: the mesh-sharded runtime (`fl/mesh.py`) and LoRA deltas
# (`fl/lora.py`). MESH_FL is the paper's FEMNIST run at full width.
MESH_FL = dict(dataset="femnist", network="gaia", topology="multigraph",
               rounds=ROUNDS, eval_every=15, momentum=0.9)
MESH_SHARDS = (1, 2, 4, 8)
MESH_BACKENDS = ("halo", "all_gather")
#: the stacked shard count whose shard-local kernel makes the `kernels` row
MESH_ROW_SHARDS = 4
#: run_reduced_fl with LoRA (the CLI's defaults otherwise), card vs host
LORA_TRAIN = dict(mesh=2, lora_rank=4)
LORA_LOSS_RTOL = 1e-4
#: LoRA at full width: mamba2-370m, 4 gaia silos, 2 shards; a warm-up
#: call of the cycle function over the first `warm_rounds` rounds, then
#: the whole 60-round multigraph cycle in one timed call
LORA_FULL = dict(arch="mamba2-370m", silos=4, rank=8, seq_len=32,
                 batch_size=4, mesh=2, lr=3e-3, warm_rounds=4)


def _captured_train(torch, cfg) -> dict:
    """`train(cfg)` on the card with the launch count zeroed just before
    and read just after, its cycle function wrapped to keep the last
    state and to time each call (synchronised): the result, the final
    state in the single-device layout (`gather_flat_state` for a mesh
    run), the runtime, the launches, the shard axis's bytes and the ms a
    round of the steady calls (every call but the first)."""
    from repro_torch.fl import mesh as flmesh
    from repro_torch.fl import runtime as flrt
    from repro_torch.fl import train
    from repro_torch.kernels.gossip_combine import ops

    make, seen = flrt.make_cycle_fn, {"secs": [], "rounds": []}

    def wrapped(rt, **kw):
        cycle = make(rt, **kw)
        seen["rt"] = rt

        def run(state, batches, strong, coeffs, diag):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = cycle(state, batches, strong, coeffs, diag)
            torch.cuda.synchronize()
            seen["secs"].append(time.perf_counter() - t0)
            seen["rounds"].append(strong.shape[0])
            seen["state"] = out[0]
            return out

        return run

    flrt.make_cycle_fn = wrapped
    try:
        ops.edge_aggregate.launches = 0
        res = train(cfg, device="cuda")
        launches = ops.edge_aggregate.launches
    finally:
        flrt.make_cycle_fn = make
    rt, state = seen["rt"], seen["state"]
    moved = None
    if isinstance(rt, flmesh.MeshRuntime):
        moved = rt.axis.bytes_moved
        state = flmesh.gather_flat_state(rt, state)
    return dict(res=res, state=state, rt=rt, launches=launches,
                bytes_moved=moved,
                ms_per_round=1e3 * sum(seen["secs"][1:])
                / sum(seen["rounds"][1:]))


def _state_diff(torch, a, b) -> dict:
    """Largest |a - b| of the rows, buffers and momentum of two flat
    states, each over the largest |b|; 0.0 where bit-equal."""
    out = {}
    for name, x, y in (("w", a.w, b.w), ("buffers", a.buffers, b.buffers),
                       ("mu", a.opt_state["mu"], b.opt_state["mu"])):
        out[name] = 0.0 if torch.equal(x, y) else float(
            (x - y).abs().max() / y.abs().max())
    return out


def _rel(a, b) -> float:
    """Largest |a - b| over the largest |b| of two lists of numbers."""
    return max(abs(x - y) for x, y in zip(a, b)) / max(abs(y) for y in b)


def _mesh_stage(torch, rt, d: int, backend: str) -> bool:
    """The gather-and-aggregate stage alone, on identical inputs: one
    round of the flat and of the mesh cycle from the same random rows and
    buffers at the run's width, under a loss whose gradient is exactly 0
    (local SGD leaves the rows as they are); the mesh's pad rows and pad
    edge buffers hold NaN. True when the mesh's gathered rows and buffers
    equal the flat cycle's bit for bit (no pad is ever read)."""
    import dataclasses
    from repro_torch.fl import flat as flatmod
    from repro_torch.fl import mesh as flmesh
    from repro_torch.fl import runtime as flrt
    from repro_torch.optim import flat_sgd

    n, t = rt.num_silos, rt.spec.size
    rt = dataclasses.replace(rt, spec=flatmod.make_flat_spec(
        {"w": torch.empty(t, device="meta")}))
    loss = lambda p, b: torch.sum(p["w"] * b["t"])  # its gradient: b["t"]
    gen = torch.Generator(device="cuda").manual_seed(11)
    w = torch.randn((n, t), generator=gen, device="cuda")
    buf = torch.randn((len(rt.dst_sorted), t), generator=gen, device="cuda")
    opt = flat_sgd(0.05, momentum=0.9)
    batches = {"t": torch.zeros((1, 1, n, 1), device="cuda")}
    k = 1 % rt.num_rounds_cycle
    plan = [torch.as_tensor(x[k:k + 1], device="cuda")
            for x in (rt.strong, rt.coeffs, rt.diag)]
    flat, _ = flrt.make_cycle_fn(rt, loss_fn=loss, opt=opt)(
        flrt.FlatFLState(w, opt.init(w), buf), batches, *plan)
    mrt = flmesh.make_mesh_runtime(rt, d, device="cuda")
    nan = torch.full((1, t), float("nan"), device="cuda")
    wp = torch.cat([w, nan.expand(mrt.mspec.rows_padded - n, t)])
    bp = torch.cat([buf, nan])[torch.as_tensor(mrt.edge_perm,
                                               device="cuda")]
    st, _ = flrt.make_cycle_fn(mrt, loss_fn=loss, opt=opt, gossip=backend)(
        flrt.FlatFLState(wp, opt.init(wp), bp), batches, *plan)
    got = flmesh.gather_flat_state(mrt, st)
    return torch.equal(got.w, flat.w) and torch.equal(got.buffers,
                                                      flat.buffers)


def _silo_grad_by_batch(torch, cfg, sizes) -> dict:
    """Silo 0's FEMNIST gradient when `torch.func.vmap` batches m silos
    in one call, against the N silos of the flat runtime, on the run's
    first batch (rows past N retrain silo 0's batch, as the mesh's pad
    rows do): for each m of ``sizes``, the largest |difference| over the
    largest |value|; 0.0 where bit-equal."""
    import numpy as np
    from repro_torch.data.synthetic import make_federated_dataset
    from repro_torch.fl import flat as flatmod
    from repro_torch.fl.trainer import _sample_round
    from repro_torch.models.small import SMALL_MODELS
    from repro_torch.networks.registry import get_network

    n = get_network(cfg.network).num_silos
    spec = SMALL_MODELS["femnist_cnn"]
    params = spec.init(torch.Generator().manual_seed(cfg.seed))
    fs = flatmod.make_flat_spec(params)
    w0 = flatmod.ravel(fs, params).cuda()
    data = make_federated_dataset(cfg.dataset, n,
                                  samples_per_silo=cfg.samples_per_silo,
                                  alpha=cfg.alpha, seed=cfg.seed)
    xs, ys = _sample_round(data, n, cfg, np.random.default_rng(cfg.seed + 1))
    batch = {"x": torch.as_tensor(xs[0], device="cuda"),
             "y": torch.as_tensor(ys[0], dtype=torch.long, device="cuda")}
    grads = torch.func.vmap(torch.func.grad(spec.loss))

    def silo0(m):
        idx = torch.as_tensor([i if i < n else 0 for i in range(m)],
                              device="cuda")
        g = grads(flatmod.unravel_stacked(fs, w0.repeat(m, 1)),
                  {k: v[idx] for k, v in batch.items()})
        return flatmod.ravel_stacked(fs, g)[0]

    ref = silo0(n)
    out = {}
    for m in sorted(set(sizes)):
        g = silo0(m)
        out[m] = 0.0 if torch.equal(g, ref) else float(
            (g - ref).abs().max() / ref.abs().max())
    return out


def _mesh_femnist(torch, ctx) -> dict:
    """(a) and (e): `run_fl` on FEMNIST at full width over the flat
    runtime, then on MESH_SHARDS stacked shards with both backends, each
    held against the flat run: simulated seconds equal, one launch a
    round for any D, and bit-equal losses, accuracies, rows, buffers and momentum;
    the gather-and-aggregate stage alone bit-equal on identical inputs
    for every case. Beside them, silo 0's gradient by the number of silos
    one `vmap` call batches (`_silo_grad_by_batch`): cuDNN picks another
    grouped-convolution algorithm for 2 or 3 silos than for 11, which is
    why the stacked binding batches all its shards' silos in one call
    (11, 12 or 16 of them). Then `run_fl(mesh="auto")` in a one-rank NCCL
    group (`GroupShards` with CUDA tensors), bit-equal to D = 1."""
    import socket
    import torch.distributed as dist
    from repro_torch.fl import FLConfig
    from repro_torch.fl.gossip import fabric_rows_per_round
    from repro_torch.launch.mesh import GroupShards

    cfg = FLConfig(**MESH_FL)
    flat = _captured_train(torch, cfg)
    f_res, t = flat["res"], flat["rt"].spec.size
    if flat["launches"] != ROUNDS:
        raise AssertionError(f"mesh: the flat run launched "
                             f"{flat['launches']} times")
    runs, failures = {}, []
    for d in MESH_SHARDS:
        for backend in MESH_BACKENDS:
            r = _captured_train(torch, FLConfig(**MESH_FL, mesh=d,
                                                gossip=backend))
            res, mrt = r["res"], r["rt"]
            diff = _state_diff(torch, r["state"], flat["state"])
            rows = fabric_rows_per_round(
                backend, halo_rows=mrt.halo.halo_rows, num_shards=d,
                rows_padded=mrt.mspec.rows_padded)
            runs[f"{d}/{backend}"] = row = dict(
                shards=d, backend=backend, launches=r["launches"],
                silos_batched=mrt.mspec.rows_padded,
                ms_per_round=r["ms_per_round"],
                fabric_bytes_per_round=rows * t * 4,
                bytes_moved_per_round=r["bytes_moved"] / ROUNDS,
                losses_equal=res.round_losses == f_res.round_losses,
                accs_equal=res.eval_accs == f_res.eval_accs,
                loss_rel=_rel(res.round_losses, f_res.round_losses),
                state_rel=diff,
                stage_bit_equal=_mesh_stage(torch, flat["rt"], d, backend))
            row["bit_equal"] = (row["losses_equal"] and row["accs_equal"]
                                and not any(diff.values()))
            if r["launches"] != ROUNDS:
                failures.append(f"{d}/{backend}: {r['launches']} launches")
            if (res.cycle_times_ms != f_res.cycle_times_ms
                    or res.total_time_s != f_res.total_time_s):
                failures.append(f"{d}/{backend}: simulated clock differs")
            if not row["stage_bit_equal"]:
                failures.append(f"{d}/{backend}: the gather-and-aggregate "
                                "stage differs on identical inputs")
            if not all(math.isfinite(x) for x in res.round_losses):
                failures.append(f"{d}/{backend}: losses "
                                f"{res.round_losses}")
            if d == MESH_ROW_SHARDS and backend == "halo":
                ctx["launches"]["edge_aggregate_mesh"] = r["launches"]
            del r
        fab = {b: runs[f"{d}/{b}"]["fabric_bytes_per_round"]
               for b in MESH_BACKENDS}
        if fab["halo"] > fab["all_gather"]:
            failures.append(f"D={d}: halo moves more than all_gather {fab}")
        torch.cuda.empty_cache()
    batched = [v["silos_batched"] for v in runs.values()]
    grad_rel = _silo_grad_by_batch(torch, cfg, [2, 3, *batched])
    inexact = [k for k, v in runs.items() if not v["bit_equal"]]
    if inexact:
        failures.append(f"runs {inexact} not bit-equal to the flat run; "
                        "silo 0's gradient by silos batched: "
                        f"{grad_rel}")
    # (e) the group binding with CUDA tensors: one NCCL rank
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        group = _captured_train(torch, FLConfig(**MESH_FL, mesh="auto"))
    finally:
        dist.destroy_process_group()
    one = _captured_train(torch, FLConfig(**MESH_FL, mesh=1))
    nccl = dict(axis=type(group["rt"].axis).__name__,
                launches=group["launches"],
                ms_per_round=group["ms_per_round"],
                bit_equal_to_one_stacked_shard=(
                    group["res"].round_losses == one["res"].round_losses
                    and group["res"].eval_accs == one["res"].eval_accs
                    and not any(_state_diff(torch, group["state"],
                                            one["state"]).values())))
    if not isinstance(group["rt"].axis, GroupShards) \
            or not nccl["bit_equal_to_one_stacked_shard"]:
        failures.append(f"one-rank NCCL group: {nccl}")
    return dict(flat=dict(ms_per_round=flat["ms_per_round"],
                          launches=flat["launches"],
                          total_time_s=f_res.total_time_s,
                          round_losses=f_res.round_losses,
                          eval_accs=f_res.eval_accs),
                runs=runs, silo0_grad_rel_by_silos_batched=grad_rel,
                not_bit_equal=inexact, nccl_one_rank=nccl,
                failures=failures), flat["rt"]


def _lora_serving(torch, ckpt_dir) -> dict:
    """The `lora_delta` checkpoint served by `RegionalFleet` on the card:
    each region's variant bit-equal to `apply_delta(lora_base, mean of
    its delta rows)`, and the tokens of one load equal to those of a
    fleet over a `full` twin checkpoint of those materialised variants
    (float64 rows, so that the mean of a region's identical rows is
    exact)."""
    import numpy as np
    from repro_torch.checkpoint import FLCheckpoint, load_fl_checkpoint
    from repro_torch.configs import get_config, reduce
    from repro_torch.fl import flat as flatmod
    from repro_torch.fl import lora
    from repro_torch.launch.mesh import tree_leaves
    from repro_torch.serving import RegionalFleet, TrafficConfig, sweep_loads

    ckpt = load_fl_checkpoint(ckpt_dir)
    meta = ckpt.meta
    mcfg = reduce(get_config(meta["arch"]))
    fleet = RegionalFleet.from_checkpoint(ckpt, max_slots=FLEET_SLOTS,
                                          max_seq=FLEET_SEQ, device="cuda")
    base = lora.lora_base(mcfg, int(meta["seed"]), "cuda")
    dspec = flatmod.make_flat_spec(lora.delta_template(base, meta[
        "lora_rank"]))
    fspec = flatmod.make_flat_spec(base)
    twin_w = np.zeros((ckpt.num_silos, fspec.size))
    for reg in fleet.regions.values():
        mean = torch.from_numpy(np.asarray(np.mean(
            ckpt.w[reg.silo_indices], axis=0), np.float32)).cuda()
        want = lora.apply_delta(base, flatmod.unravel(dspec, mean))
        if not all(torch.equal(x, y) for x, y in zip(
                tree_leaves(reg.engine.params), tree_leaves(want))):
            raise AssertionError(f"lora fleet: region {reg.name}'s variant "
                                 "is not apply_delta of its mean delta")
        twin_w[reg.silo_indices] = flatmod.ravel(fspec, want).cpu().numpy()
    twin = RegionalFleet.from_checkpoint(
        FLCheckpoint(step=ckpt.step, w=twin_w, meta=dict(
            meta, params_kind="full", lora_rank=0)),
        max_slots=FLEET_SLOTS, max_seq=FLEET_SEQ, device="cuda")
    tokens = []
    for f in (fleet, twin):
        sweep_loads(f, TrafficConfig(**FLEET_TRAFFIC), [FLEET_LOADS[1]])
        tokens.append([q.output for r in f.regions.values()
                       for q in r.engine.completed])
    if tokens[0] != tokens[1] or not tokens[0]:
        raise AssertionError("lora fleet: its tokens differ from the full "
                             "twin's")
    return dict(regions={r: v.silo_indices for r, v in fleet.regions.items()},
                requests=len(tokens[0]), tokens_equal_to_full_twin=True,
                tokens=sum(map(len, tokens[0])), t_lora=dspec.size,
                t_full=fspec.size)


def _mesh_lora(torch, tmp: Path) -> dict:
    """(c) `run_reduced_fl` with LORA_TRAIN at the CLI's defaults on the
    card (launch count zeroed just before and read just after: one a
    round for both shards) and on the host from the same start (the base and delta_0 are
    host draws): losses within LORA_LOSS_RTOL relative, simulated seconds
    equal; its checkpoint served (`_lora_serving`)."""
    import dataclasses
    from repro_torch.kernels.gossip_combine import ops
    from repro_torch.launch import train

    cfg = train.TrainConfig(**LORA_TRAIN, ckpt_dir=str(tmp / "lora"))
    ops.edge_aggregate.launches = 0
    t0 = time.perf_counter()
    card = train.run_reduced_fl(cfg)
    card_s = time.perf_counter() - t0
    launches = ops.edge_aggregate.launches
    t0 = time.perf_counter()
    cpu = train.run_reduced_fl(dataclasses.replace(cfg, ckpt_dir=None),
                               device="cpu")
    cpu_s = time.perf_counter() - t0
    rel = max(abs(a - b) / abs(b) for a, b in zip(card["losses"],
                                                  cpu["losses"]))
    if launches != cfg.rounds:
        raise AssertionError(f"lora run: {launches} launches in "
                             f"{cfg.rounds} rounds")
    if _not_finite(card["losses"]) or rel > LORA_LOSS_RTOL:
        raise AssertionError(f"lora run: card losses {rel} relative from "
                             f"the host's (limit {LORA_LOSS_RTOL})")
    for k in ("sim_mean_cycle_ms", "sim_total_time_s"):
        if card[k] != cpu[k]:
            raise AssertionError(f"lora run: {k} differs on card and host")
    serving = _lora_serving(torch, cfg.ckpt_dir)
    return dict(config=dict(LORA_TRAIN, arch=cfg.arch, silos=cfg.silos,
                            rounds=cfg.rounds), launches=launches,
                card_s=card_s, cpu_s=cpu_s, loss_max_rel_card_vs_cpu=rel,
                loss_rtol=LORA_LOSS_RTOL, losses_card=card["losses"],
                sim_total_time_s=card["sim_total_time_s"], serving=serving)


def _mesh_lora_full(torch) -> dict:
    """(d) LoRA deltas (rank LORA_FULL["rank"]) over mamba2-370m at full
    width and depth (bf16 base, random weights drawn on the card), 4 gaia
    silos on 2 stacked shards, on seeded random tokens: a warm-up call
    over the first LORA_FULL["warm_rounds"] rounds of the multigraph
    cycle, then the whole cycle in one call, timed (synchronised): T_lora,
    ms a round of the whole cycle (and of the warm-up call, which
    includes first-call allocations), peak memory, finite losses, one
    launch a round in each call."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.delay import WORKLOADS
    from repro_torch.fl import flat as flatmod
    from repro_torch.fl import lora
    from repro_torch.fl import mesh as flmesh
    from repro_torch.fl import runtime as flrt
    from repro_torch.fl.dpasgd import make_round_schedule
    from repro_torch.kernels.gossip_combine import ops
    from repro_torch.launch.mesh import tree_leaves
    from repro_torch.launch.train import _sub_network
    from repro_torch.models import transformer as tf
    from repro_torch.networks.registry import get_network
    from repro_torch.optim import flat_sgd

    c = LORA_FULL
    mcfg = get_config(c["arch"])
    net = _sub_network(get_network("gaia"), c["silos"])
    n = net.num_silos
    plan, _ = make_round_schedule("multigraph", net, WORKLOADS["femnist"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = tf.init_params(mcfg, torch.Generator(device="cuda").manual_seed(1),
                          device="cuda")
    t_full = sum(x.numel() for x in tree_leaves(base))
    adapter = lora.make_lora_adapter(base, c["rank"])
    delta0 = adapter.init(torch.Generator().manual_seed(0))
    rt = flrt.make_flat_runtime(plan, delta0, n)
    mrt = flmesh.make_mesh_runtime(rt, c["mesh"], device="cuda")
    opt = flat_sgd(c["lr"], momentum=0.9)
    state = flmesh.init_mesh_state(flatmod.ravel(rt.spec, delta0), opt, mrt)
    cycle = flrt.make_cycle_fn(
        mrt, loss_fn=adapter.wrap_loss(
            lambda p, b: tf.loss_fn(p, mcfg, b)[0]), opt=opt)
    # (`make_lm_dataset` builds a vocab x vocab bigram table: 50,280^2)
    rng = np.random.default_rng(0)

    def timed_call(state, r):
        """One cycle-function call over the plan's first r rounds:
        (state, losses, seconds, launches)."""
        toks = torch.as_tensor(rng.integers(
            0, mcfg.vocab_size, (r, n, c["batch_size"], c["seq_len"] + 1)),
            device="cuda")
        batches = {"tokens": toks[:, None, :, :, :-1],
                   "labels": toks[:, None, :, :, 1:]}
        args = [torch.as_tensor(x[:r], device="cuda")
                for x in (rt.strong, rt.coeffs, rt.diag)]
        ops.edge_aggregate.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, losses = cycle(state, batches, *args)
        losses = losses.tolist()
        secs = time.perf_counter() - t0
        launches = ops.edge_aggregate.launches
        if _not_finite(losses) or launches != r:
            raise AssertionError(f"lora at full width: losses {losses}, "
                                 f"{launches} launches over {r} rounds")
        return state, losses, secs, launches

    warm = c["warm_rounds"]
    state, _, warm_s, _ = timed_call(state, warm)
    r = plan.num_rounds_cycle
    state, losses, secs, launches = timed_call(state, r)
    peak = torch.cuda.max_memory_allocated()
    del base, adapter, state, cycle
    torch.cuda.empty_cache()
    return dict(config=c, cycle_rounds=r, t_lora=rt.spec.size,
                t_full=t_full, t_lora_share=rt.spec.size / t_full,
                launches=launches, cycle_s=secs, ms_per_round=1e3 * secs / r,
                warm_up_ms_per_round=1e3 * warm_s / warm,
                peak_memory_gb=peak / 1e9, losses_first_last=[losses[0],
                                                              losses[-1]])


def phase_fl_mesh(torch, ctx):
    """The mesh-sharded runtime and LoRA deltas on the card: (a) and (e)
    `_mesh_femnist` with deterministic algorithms on; (c) `_mesh_lora`
    and (d) `_mesh_lora_full` without, as the other LLM phases run (the
    fused kernel on the shard blocks is timed in phase edge_aggregate).
    No profile. One line a part, its seconds in it."""
    import tempfile

    _deterministic(torch)
    t0 = time.perf_counter()
    femnist, rt = _mesh_femnist(torch, ctx)
    ctx["fl_mesh_runs"] = (rt.spec.size, femnist["runs"])
    emit(phase="fl_mesh", part="femnist", nvidia_smi=ctx["smi"],
         seconds=time.perf_counter() - t0, **femnist)
    torch.use_deterministic_algorithms(False)
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        lora = _mesh_lora(torch, Path(tmp))
    emit(phase="fl_mesh", part="lora", seconds=time.perf_counter() - t1,
         **lora)
    t1 = time.perf_counter()
    full = _mesh_lora_full(torch)
    emit(phase="fl_mesh", part="lora_full", seconds=time.perf_counter() - t1,
         nvidia_smi=ctx["smi"], **full)
    failures = femnist["failures"]
    emit(phase="fl_mesh", ok=not failures, seconds=time.perf_counter() - t0,
         failures=failures)
    if failures:
        raise AssertionError(f"fl_mesh: {failures}")


def _timed(ctx, arch: str, mode: str, batch: int, seq: int, ms: float,
           **extra) -> None:
    """Keep a timed prefill or train step for `phase_launch_analysis`:
    ``seq`` counts the token positions (a prefix's are added by the
    analytic model)."""
    ctx.setdefault("timed_steps", []).append(dict(
        arch=arch, mode=mode, batch=batch, seq=seq, ms=ms, **extra))


#: The dry run's peak of a train step against `max_memory_allocated` of
#: the same step on the card: measured / dry within this band (set in
#: PERF.md before the phase first ran on a card).
DRY_PEAK_BAND = (0.95, 1.15)
#: The dryrun CLI's check in the smoke: mamba2-370m x train_4k on both
#: meshes, cut to one layer (a full-depth train_4k pair traces for
#: minutes on the host).
DRYRUN_CLI = ("--arch", "mamba2-370m", "--shape", "train_4k", "--mesh",
              "both", "--layers", "1")


def _dry_train_peak(arch: str) -> dict:
    """The dry run of `llm_train`'s step for ``arch`` (4 x 2048,
    microbatch 1, "h100"), in a worker process of its own."""
    sys.path.insert(0, str(SRC))
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import InputShape
    rep = dryrun.dry_pair(arch, InputShape("llm_train", "train",
                                           TRAIN_SHAPE[1], TRAIN_SHAPE[0]),
                          "h100", microbatch=1)
    if rep["status"] != "ok":
        raise RuntimeError(f"dry run of {arch}: {rep.get('error')}")
    return dict(peak_bytes=rep["memory"]["peak_bytes"],
                argument_bytes=rep["memory"]["argument_bytes"],
                flops=rep["cost"]["flops"], trace_s=rep["trace_s"])


#: Host work that needs no card (`start_host_work`) starts once this
#: phase has run, so that it runs beside the card phases after it
#: rather than competing with the build or the FEMNIST cycle's timing.
HOST_WORK_AFTER = "cycle"
_ONE_THREAD = {var: "1" for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                                    "OPENBLAS_NUM_THREADS")}


def _host_worker_init() -> None:
    """One thread for each math library in a host worker, so that the
    workers leave the cores to the process driving the card."""
    os.environ.update(_ONE_THREAD)
    sys.path.insert(0, str(SRC))
    import torch
    torch.set_num_threads(1)


class _DryrunCli:
    """`python -m repro_torch.launch.dryrun` on ``args`` (DRYRUN_CLI by
    default), writing into ``tmp``, in a process of its own; `get` gives
    its exit code, the end of its errors and its seconds."""

    def __init__(self, tmp: str, args=DRYRUN_CLI):
        import threading

        self.tmp, t0 = Path(tmp), time.perf_counter()
        self.tmp.mkdir(exist_ok=True)
        self.err = open(self.tmp / "dryrun.err", "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
             "--out", str(self.tmp)], cwd=self.tmp,
            env=dict(os.environ, PYTHONPATH=str(SRC), **_ONE_THREAD),
            stdout=subprocess.DEVNULL, stderr=self.err)
        self.seconds = None

        def wait():
            self.proc.wait()
            self.seconds = time.perf_counter() - t0

        self.waiter = threading.Thread(target=wait, daemon=True)
        self.waiter.start()

    def get(self, timeout: float) -> dict:
        self.waiter.join(timeout)
        if self.seconds is None:
            raise TimeoutError(f"dryrun CLI still running after {timeout} s")
        self.err.close()
        return dict(rc=self.proc.returncode, seconds=self.seconds,
                    stderr_tail=(self.tmp / "dryrun.err").read_text()[-600:])

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self.err.close()


#: The sharded program's dry run in the smoke: yi-9b x train_4k on the
#: reference's (16, 16) mesh as rank 0 of a fake 256-rank world, one layer.
SHARDED_DRYRUN_CLI = ("--arch", "yi-9b", "--shape", "train_4k", "--mesh",
                      "h100x256", "--layers", "1")


def _fl8_dry_states() -> list:
    """`fl8`'s three dry states (mamba2-370m's ring round over the pod
    axis of a fake (8, 8, 8) world), in a worker process."""
    sys.path.insert(0, str(SRC))
    from repro_torch.launch import fl8
    return [fl8.dry_state(name, fl8.ARCH, left, right)
            for name, left, right in fl8.STATES]


def start_host_work(ctx) -> None:
    """Start, in a pool of worker processes, the smoke's host work that
    needs no card: the dry runs of `llm_train`'s steps and the dryrun CLI
    (read by `phase_launch_analysis`), the sharded dry run and `fl8`'s dry
    states (read by `phase_sharded_host`) and the host scorer's candidate
    sets (read by `phase_design_search`)."""
    import multiprocessing
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    pool = multiprocessing.get_context("spawn").Pool(
        len(TRAIN_ARCHS) + 1, initializer=_host_worker_init)
    jobs = {f"dry_peak/{arch}": pool.apply_async(_dry_train_peak, (arch,))
            for arch in TRAIN_ARCHS}
    jobs["dryrun_cli"] = _DryrunCli(tmp)
    jobs["dryrun_sharded"] = _DryrunCli(str(Path(tmp) / "sharded"),
                                        SHARDED_DRYRUN_CLI)
    jobs["fl8_dry"] = pool.apply_async(_fl8_dry_states)
    jobs["scores_numpy"] = pool.apply_async(_score, ("numpy",))
    ctx["host_work"] = dict(tmp=tmp, pool=pool, jobs=jobs, waited_s={})


def host_result(ctx, name: str):
    """The result of host job ``name``, waiting for it if it is still
    running (the seconds waited are kept for the timeline)."""
    t0 = time.perf_counter()
    res = ctx["host_work"]["jobs"][name].get(timeout=900)
    ctx["host_work"]["waited_s"][name] = time.perf_counter() - t0
    return res


def stop_host_work(ctx) -> dict:
    """End every host worker and remove their directory; the seconds each
    job was waited for."""
    import shutil

    work = ctx.pop("host_work", None)
    if work is None:
        return {}
    for job in work["jobs"].values():
        if isinstance(job, _DryrunCli):
            job.stop()
    work["pool"].terminate()
    work["pool"].join()
    shutil.rmtree(work["tmp"], ignore_errors=True)
    return work["waited_s"]


def phase_launch_analysis(torch, ctx):
    """The launch analysis tools against the card's own readings; no
    kernel is launched. (a) Every timed prefill and train step above
    against its analytic bound on this card (`roofline.bound_ms`): no
    step under it. (b) The dry run's peak bytes of `llm_train`'s steps
    (traced on fake tensors in worker processes by `start_host_work`)
    against their `max_memory_allocated`, within DRY_PEAK_BAND. (c)
    `fl_mesh`'s `fabric_bytes` readings equal to `fl_mesh_fabric_bytes`
    of `fl_mesh_report(network="gaia")` at FEMNIST's width, for both
    backends at every D. (d) `python -m repro_torch.launch.dryrun` on
    DRYRUN_CLI (started by `start_host_work`) and `python -m
    repro_torch.launch.roofline` on its output: both exit 0."""
    from repro_torch.configs import get_config
    from repro_torch.launch import roofline
    from repro_torch.launch.specs import InputShape

    t0 = time.perf_counter()
    failures = []
    env = dict(os.environ, PYTHONPATH=str(SRC))
    # (a) the bounds
    bounds = []
    for st in ctx["timed_steps"]:
        cfg = get_config(st["arch"])
        shape = InputShape(st["mode"], st["mode"], st["seq"], st["batch"])
        b = roofline.bound_ms(cfg, shape, card=ctx["kind"])
        row = dict(arch=cfg.name, mode=st["mode"], batch=st["batch"],
                   seq=st["seq"], ms=st["ms"], **b,
                   bound_share=b["bound_ms"] / st["ms"])
        bounds.append(row)
        if st["ms"] < b["bound_ms"]:
            failures.append(f"{cfg.name} {st['mode']}: {st['ms']} ms under "
                            f"its bound {b['bound_ms']} ms")
    # (c) the fabric bytes
    t, runs = ctx["fl_mesh_runs"]
    fabric = {}
    for key, run in runs.items():
        rep = roofline.fl_mesh_report("mamba2-370m", network="gaia",
                                      num_shards=run["shards"])
        want = roofline.fl_mesh_fabric_bytes(rep, run["backend"], t)
        fabric[key] = dict(read=run["fabric_bytes_per_round"], report=want,
                           halo_rows_per_device=rep["halo_rows"],
                           per_shard_rows=rep["per_shard_rows"])
        if run["fabric_bytes_per_round"] != want:
            failures.append(f"fabric bytes {key}: read "
                            f"{run['fabric_bytes_per_round']}, report {want}")
    if t != MAIN_SHAPE["t"]:
        failures.append(f"fl_mesh ran T={t}, not FEMNIST's")
    # (b) the dry run's peaks
    peaks = {}
    measured = {st["arch"]: st["peak_bytes"] for st in ctx["timed_steps"]
                if st["mode"] == "train"}
    for arch in TRAIN_ARCHS:
        dry = host_result(ctx, f"dry_peak/{arch}")
        ratio = measured[arch] / dry["peak_bytes"]
        peaks[arch] = dict(max_memory_allocated=measured[arch], **dry,
                           measured_over_dry=ratio)
        if not DRY_PEAK_BAND[0] <= ratio <= DRY_PEAK_BAND[1]:
            failures.append(f"{arch}: max_memory_allocated / dry peak "
                            f"{ratio} outside {DRY_PEAK_BAND}")
    # (d) the CLIs
    dry_cli = host_result(ctx, "dryrun_cli")
    tmp = ctx["host_work"]["tmp"]
    roof = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.roofline", tmp],
        cwd=tmp, env=env, capture_output=True, text=True, timeout=120)
    clis = dict(dryrun_rc=dry_cli["rc"], dryrun_tail=dry_cli["stderr_tail"],
                dryrun_s=dry_cli["seconds"], roofline_rc=roof.returncode,
                table=roof.stdout.strip().splitlines())
    if dry_cli["rc"] or roof.returncode or len(clis["table"]) != 4:
        failures.append(f"CLIs: {clis}")
    emit(phase="launch_analysis", ok=not failures,
         seconds=time.perf_counter() - t0, nvidia_smi=ctx["smi"],
         bounds=bounds, dry_peaks=peaks, peak_band=DRY_PEAK_BAND,
         fabric_bytes=fabric, clis=clis, failures=failures)
    if failures:
        raise AssertionError(f"launch_analysis: {failures}")


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


#: The design_loop phase: `evaluate_frontier` at its defaults (60 rounds,
#: batch 16, 64 samples a silo) over three vectors, `attach_tta` over
#: TTA_ROUNDS, and the fault scenarios over the paper's 6,400 rounds.
DESIGN_ROUNDS = 60
TTA_ROUNDS = 40
DESIGN_SCENARIOS = ("nominal", "drift", "diurnal", "flash", "churn")


def _design_vectors():
    """Algorithm 1's multiplicity vector at t = 5 over gaia's ring overlay
    (in `overlay.pairs` order), the all-ones vector over the same overlay
    and Algorithm 1's at t = 3."""
    from repro_torch.core.delay import FEMNIST
    from repro_torch.core.multigraph import build_multigraph
    from repro_torch.design.catalog import ring_topology
    from repro_torch.networks.registry import get_network

    gaia = get_network("gaia")
    overlay = ring_topology(gaia, FEMNIST).graph

    def vector(t):
        mg = build_multigraph(gaia, FEMNIST, overlay, t=t)
        return tuple(int(mg.multiplicity[p]) for p in overlay.pairs)

    t5 = vector(5)
    return [("algorithm1_t5", t5), ("ones", (1,) * len(t5)),
            ("algorithm1_t3", vector(3))]


def _frontier(torch) -> dict:
    """The frontier on the card with the launch count zeroed just before
    and read just after (one `edge_aggregate` a round per candidate);
    each candidate against `evaluate_design` (`run_fl` of its vector),
    bit for bit in every field but the host seconds, and the first
    against `train(cfg, aggregator="reference")`."""
    import dataclasses
    from repro_torch.design import evaluate
    from repro_torch.fl import FLConfig, train
    from repro_torch.kernels.gossip_combine import ops
    from repro_torch.obs import TraceRecorder

    named = _design_vectors()
    rec = TraceRecorder()
    ops.edge_aggregate.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = evaluate.evaluate_frontier("gaia", "femnist", named,
                                     rounds=DESIGN_ROUNDS, recorder=rec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.edge_aggregate.launches
    if launches != len(named) * DESIGN_ROUNDS:
        raise AssertionError(f"frontier: edge_aggregate launched {launches} "
                             f"times for {len(named)} x {DESIGN_ROUNDS} rounds")
    rows = []
    for (name, vec), got, span in zip(named, res, rec.host_events):
        if not (math.isfinite(got.final_loss) and
                math.isfinite(got.target_loss)):
            raise AssertionError(f"frontier {name}: non-finite {got}")
        one = evaluate.evaluate_design(
            "gaia", "femnist", multiplicity=vec, name=name,
            rounds=DESIGN_ROUNDS, target_loss=res[0].target_loss)
        if dataclasses.replace(one, train_s=0.0) != \
                dataclasses.replace(got, train_s=0.0):
            raise AssertionError(f"frontier {name} != run_fl: {got} vs {one}")
        rows.append(dict(got.row(), host_ms_per_round=span["dur_ms"]
                         / DESIGN_ROUNDS, span=span["name"],
                         run_fl_train_s=one.train_s))
    cfg = FLConfig(dataset="femnist", network="gaia", topology="multigraph",
                   rounds=DESIGN_ROUNDS, eval_every=DESIGN_ROUNDS,
                   batch_size=16, samples_per_silo=64,
                   multiplicity=named[0][1])
    kern = train(cfg)
    plain = train(cfg, aggregator="reference")
    smooth = evaluate.smoothed_losses(plain.round_losses)
    if (plain.round_losses != kern.round_losses
            or plain.eval_accs != kern.eval_accs
            or float(smooth[-1]) != res[0].final_loss
            or plain.final_acc() != res[0].final_acc):
        raise AssertionError("frontier: the plain aggregation diverged from "
                             "the kernel's")
    return dict(rounds=DESIGN_ROUNDS, batch_size=16, samples_per_silo=64,
                launches=launches, wall_s=wall, candidates=rows,
                run_fl_equal=True, reference_aggregator_equal=True)


def _paper_grid() -> dict:
    """The paper's whole grid on the host (7 topologies x 5 networks x 3
    workloads at 6,400 rounds), Tables 1 and 3, and `consistency_check`
    on the `--quick` config."""
    import contextlib
    import io
    from repro_torch.core import sweep

    t0 = time.perf_counter()
    cells = sweep.run_sweep(sweep.SweepConfig())
    grid_s = time.perf_counter() - t0
    want = (len(sweep.PAPER_TOPOLOGIES) * len(sweep.PAPER_NETWORKS)
            * len(sweep.PAPER_WORKLOADS))
    if len(cells) != want or not all(
            math.isfinite(c.report.total_time_s) for c in cells):
        raise AssertionError(f"sweep: {len(cells)} cells, want {want}")
    t0 = time.perf_counter()
    table1, table3 = sweep.format_table1(cells), sweep.format_table3(cells)
    tables_s = time.perf_counter() - t0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        sweep.consistency_check(sweep.SweepConfig(
            networks=("gaia", "geant"), workloads=("femnist",)))
    check_s = time.perf_counter() - t0
    return dict(cells=len(cells), host_s=grid_s,
                construct_s=sum(c.construct_ms for c in cells) / 1e3,
                eval_s=sum(c.eval_ms for c in cells) / 1e3,
                format_s=tables_s, table1=table1.splitlines(),
                table3=table3.splitlines(),
                consistency_check=buf.getvalue().strip(),
                consistency_check_s=check_s)


def phase_design_loop(torch, ctx):
    """The design loop on the card and the paper's tables on its host:
    the frontier (`_frontier`), `attach_tta` on the gaia / femnist
    multigraph cell against a direct `evaluate_design`, the paper grid
    (`_paper_grid`), `scenario_cycle_times` of the gaia multigraph under
    DESIGN_SCENARIOS (nominal bit-equal to `cycle_times`, the others
    finite and at or above its total) and one drift trace written by
    `python -m repro_torch.obs trace` and checked by its `validate`.
    The tables' times and `tta_s` are simulated seconds of the paper's
    network model, not times of the card."""
    import tempfile
    import numpy as np
    from repro_torch.core import sweep, timing
    from repro_torch.core.delay import FEMNIST
    from repro_torch.design import evaluate
    from repro_torch.faults import get_scenario
    from repro_torch.networks.registry import get_network

    _deterministic(torch)
    t_phase = time.perf_counter()
    frontier = _frontier(torch)
    ctx["launches"]["edge_aggregate_design_loop"] = frontier["launches"]

    t0 = time.perf_counter()
    cells = sweep.run_sweep(sweep.SweepConfig(
        topologies=("multigraph",), networks=("gaia",),
        workloads=("femnist",), num_rounds=TTA_ROUNDS))
    cell = sweep.attach_tta(cells, rounds=TTA_ROUNDS)[0]
    direct = evaluate.evaluate_design("gaia", "femnist", t=5,
                                      rounds=TTA_ROUNDS)
    if not (cell.tta_s is not None and math.isfinite(cell.tta_s)
            and (cell.tta_s, cell.tta_final_acc, cell.tta_target_loss)
            == (direct.tta_s, direct.final_acc, direct.target_loss)):
        raise AssertionError(f"attach_tta: {cell} vs {direct}")
    tta = dict(rounds=TTA_ROUNDS, tta_s=cell.tta_s,
               final_acc=cell.tta_final_acc,
               target_loss=cell.tta_target_loss,
               wall_s=time.perf_counter() - t0)

    grid = _paper_grid()

    gaia = get_network("gaia")
    plan = timing.make_timing_plan("multigraph", gaia, FEMNIST)
    nominal = plan.cycle_times(sweep.SweepConfig().num_rounds)
    scen = {}
    for name in DESIGN_SCENARIOS:
        t0 = time.perf_counter()
        taus = sweep.scenario_cycle_times(plan, get_scenario(name),
                                          len(nominal))
        host_s = time.perf_counter() - t0
        if name == "nominal" and not np.array_equal(taus, nominal):
            raise AssertionError("the nominal scenario is not the identity")
        if not (np.isfinite(taus).all() and taus.sum() >= nominal.sum()):
            raise AssertionError(f"scenario {name}: total {taus.sum()} "
                                 f"under the nominal {nominal.sum()}")
        scen[name] = dict(total_s=float(taus.sum()) / 1e3,
                          mean_ms=float(taus.mean()), host_s=host_s)

    env = dict(os.environ, PYTHONPATH=str(SRC))
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "drift.json")
        out = {}
        for cmd in (["trace", "--scenario", "drift", "--out", path],
                    ["validate", path]):
            run = subprocess.run([sys.executable, "-m", "repro_torch.obs",
                                  *cmd], env=env, capture_output=True,
                                 text=True, timeout=300)
            if run.returncode:
                raise AssertionError(f"obs {cmd[0]}: rc {run.returncode}: "
                                     f"{run.stderr[-2000:]}")
            out[cmd[0]] = run.stdout.strip()
    emit(phase="design_loop", ok=True, nvidia_smi=ctx["smi"],
         seconds=time.perf_counter() - t_phase, frontier=frontier,
         attach_tta=tta, paper_grid=grid, scenarios=scen,
         scenario_rounds=len(nominal), trace=out,
         simulated_note="tables, tta_s and scenario totals are simulated "
                        "seconds of the paper's network model, not times "
                        "of the card")


#: The design_search phase: the scorer's candidate counts (6,400 rounds
#: each, gaia / femnist's ring overlay), the grid's rounds for the
#: per-round device-op count, `population_search` at the search CLI's
#: --quick sizes (at its defaults the device grid took 33 s on an H100,
#: PERF.md), and the controller's default runs.
SCORER_CANDIDATES = (16, 256, 4096)
GRID_OP_ROUNDS = (16, 48)
POPULATION_QUICK = dict(rounds=800, max_iters=6, pop_size=12, generations=4)
CONTROLLER_RUNS = (("nominal", False), ("nominal", True), ("churn", False),
                   ("churn", True))


def _grid_engines(torch) -> dict:
    """(a) The paper's whole grid (`run_sweep(SweepConfig())`'s 105 cells)
    by `reports` on both engines: equal report for report; each engine's
    seconds, the recurrence cells C, and the device grid's operations a
    round (the profiler's count at GRID_OP_ROUNDS[1] rounds less that at
    GRID_OP_ROUNDS[0], over the difference)."""
    from repro_torch.core import sweep, timing, timing_torch

    cfg = sweep.SweepConfig()
    plans, _ = sweep.build_sweep_plans(cfg)
    grid = timing.build_timing_grid(plans)
    t0 = time.perf_counter()
    host = grid.reports(cfg.num_rounds)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev = grid.reports(cfg.num_rounds, backend="torch")
    dev_s = time.perf_counter() - t0
    if len(dev) != 105 or dev != host:
        raise AssertionError("torch grid reports != numpy reports")
    counts = {}
    for r in GRID_OP_ROUNDS:
        seen, names, blind = device_ops_per_call(
            torch, lambda r=r: timing_torch.grid_recurrence_taus(
                grid.d0, grid.pair_comp, grid.strong, grid.trans,
                grid.lone_comp, grid.num_states, r), iters=2)
        counts[r] = dict(ops_per_call=seen, blind=blind,
                         names=sorted(n[:60] for n in names))
    lo, hi = GRID_OP_ROUNDS
    per_round = [(b - a) / (hi - lo) for a, b in
                 zip(counts[lo]["ops_per_call"], counts[hi]["ops_per_call"])]
    return dict(cells=len(plans), recurrence_cells=len(grid.rec_rows),
                rounds=cfg.num_rounds, numpy_s=host_s, torch_s=dev_s,
                reports_equal=True, device_ops_per_round=per_round,
                device_ops=counts)


def _scorer_sets():
    """gaia, FEMNIST, the ring overlay and one seeded random candidate set
    (multiplicities 1..5) per count in SCORER_CANDIDATES."""
    import numpy as np
    from repro_torch.core.delay import FEMNIST
    from repro_torch.design.catalog import ring_topology
    from repro_torch.networks.registry import get_network

    gaia = get_network("gaia")
    overlay = ring_topology(gaia, FEMNIST).graph
    rng = np.random.default_rng(22)
    sets = {count: [tuple(int(x) for x in rng.integers(1, 6,
                                                       len(overlay.pairs)))
                    for _ in range(count)] for count in SCORER_CANDIDATES}
    return gaia, FEMNIST, overlay, sets


def _score(backend: str) -> dict:
    """Each candidate set of `_scorer_sets` scored on ``backend`` at 6,400
    rounds: count -> (scores, seconds)."""
    from repro_torch.design import batched

    gaia, femnist, overlay, sets = _scorer_sets()
    out = {}
    for count, cands in sets.items():
        scorer = batched.CandidateScorer(gaia, femnist, overlay,
                                         rounds=6400, backend=backend)
        t0 = time.perf_counter()
        scores = scorer.score(cands)
        out[count] = (scores, time.perf_counter() - t0)
    return out


def _scorer_rates(ctx) -> dict:
    """(b) `CandidateScorer` on gaia / femnist's ring overlay at 6,400
    rounds: one seeded random candidate set per count in
    SCORER_CANDIDATES, scored on the card here and on the host in a
    worker process (`start_host_work`), bit-equal; candidates per
    second of each."""
    import numpy as np

    dev = _score("torch")
    host = host_result(ctx, "scores_numpy")
    out = {}
    for count in SCORER_CANDIDATES:
        row = {name: dict(seconds=res[count][1],
                          candidates_per_s=count / res[count][1])
               for name, res in (("torch", dev), ("numpy", host))}
        if not np.array_equal(dev[count][0], host[count][0]):
            raise AssertionError(f"scorer: torch != numpy at C={count}")
        row["torch_over_numpy"] = (row["torch"]["candidates_per_s"]
                                   / row["numpy"]["candidates_per_s"])
        out[str(count)] = row
    return dict(rounds=6400, candidates=out, scores_equal=True,
                numpy_in="a worker process, beside the card phases")


def _population() -> dict:
    """(c) `population_search(gaia, femnist)` at POPULATION_QUICK on the
    card ("torch") and on the host ("numpy"): equal rows but for
    `elapsed_s` and `backend`, equal pools; seconds of each."""
    from repro_torch.core.delay import FEMNIST
    from repro_torch.design import search
    from repro_torch.networks.registry import get_network

    gaia = get_network("gaia")
    res = {}
    for backend in ("torch", "numpy"):
        t0 = time.perf_counter()
        r, pool = search.population_search(gaia, FEMNIST, backend=backend,
                                           **POPULATION_QUICK)
        res[backend] = (r, pool, time.perf_counter() - t0)
    rows = [{k: v for k, v in r.row().items()
             if k not in ("elapsed_s", "backend")} for r, _, _ in
            res.values()]
    if rows[0] != rows[1] or res["torch"][1] != res["numpy"][1]:
        raise AssertionError("population_search: torch != numpy")
    best = res["torch"][0]
    return dict(**POPULATION_QUICK, best_mults=best.best_mults,
                best_mean_ms=best.best_mean_ms,
                paper_mults=best.paper_mults,
                paper_mean_ms=best.paper_mean_ms,
                improvement_pct=best.improvement_pct,
                evaluations=best.evaluations, pool=len(res["torch"][1]),
                torch_s=res["torch"][2], numpy_s=res["numpy"][2],
                rows_equal=True, pools_equal=True)


def _controller(torch) -> dict:
    """(d) `ControllerHarness(ControllerConfig())` at its defaults on the
    card: the four CONTROLLER_RUNS with the launch count zeroed just
    before and read just after (4 x 48 = 192) and `make_cycle_fn`'s
    builds counted (one); nominal static == adaptive bit for bit with no
    swap, and the static run == `evaluate_design` at the same sizes;
    churn's adaptive run below the static one in `tta_s` (to the worse
    of the two smoothed minima) and `total_time_s`; the adaptive churn
    run again through a cycle function with the plain aggregation over
    the harness's own runtime, bit-equal; host ms a round of each run;
    one traced churn run, checked by `validate_trace`."""
    import numpy as np
    from repro_torch.design import evaluate
    from repro_torch.design.controller import (ControllerConfig,
                                               ControllerHarness)
    from repro_torch.fl import runtime as flrt
    from repro_torch.kernels.gossip_combine import ops
    from repro_torch.obs import TraceRecorder, to_trace_json, validate_trace

    cfg = ControllerConfig()
    make, built = flrt.make_cycle_fn, []

    def counting(*a, **k):
        built.append(1)
        return make(*a, **k)

    flrt.make_cycle_fn = counting
    try:
        t0 = time.perf_counter()
        h = ControllerHarness(cfg)
        build_s = time.perf_counter() - t0
        ops.edge_aggregate.launches = 0
        torch.cuda.synchronize()
        runs, host = {}, {}
        for sc, ad in CONTROLLER_RUNS:
            t0 = time.perf_counter()
            runs[sc, ad] = h.run(sc, adaptive=ad)
            torch.cuda.synchronize()
            host[f"{sc}_{'adaptive' if ad else 'static'}"] = (
                (time.perf_counter() - t0) * 1e3 / cfg.rounds)
        launches = ops.edge_aggregate.launches
    finally:
        flrt.make_cycle_fn = make
    if launches != len(CONTROLLER_RUNS) * cfg.rounds or len(built) != 1:
        raise AssertionError(f"controller: {launches} launches, "
                             f"{len(built)} cycle functions built")
    for run in runs.values():
        if not np.isfinite(run.losses).all():
            raise AssertionError(f"controller {run.scenario}: non-finite")
    st, ad = runs["nominal", False], runs["nominal", True]
    if not (np.array_equal(st.losses, ad.losses)
            and np.array_equal(st.cycle_times_ms, ad.cycle_times_ms)
            and st.final_acc == ad.final_acc and ad.swap_rounds == ()):
        raise AssertionError("controller: nominal static != adaptive")
    one = evaluate.evaluate_design("gaia", "femnist", t=cfg.t,
                                   rounds=cfg.rounds,
                                   batch_size=cfg.batch_size,
                                   samples_per_silo=cfg.samples_per_silo)
    k, tta = evaluate.time_to_target(st.losses, st.cycle_times_ms,
                                     one.target_loss)
    if (float(evaluate.smoothed_losses(st.losses)[-1]) != one.final_loss
            or st.final_acc != one.final_acc
            or st.total_time_s != one.total_time_s
            or (k, tta) != (one.reached_round, one.tta_s)):
        raise AssertionError(f"controller nominal static != evaluate_design: "
                             f"{one}")
    cst, cad = runs["churn", False], runs["churn", True]
    target = float(max(evaluate.smoothed_losses(cst.losses).min(),
                       evaluate.smoothed_losses(cad.losses).min())
                   * (1 + 1e-9))
    churn = dict(target_loss=target, static_tta_s=cst.tta_s(target),
                 adaptive_tta_s=cad.tta_s(target),
                 static_total_s=cst.total_time_s,
                 adaptive_total_s=cad.total_time_s,
                 swap_rounds=cad.swap_rounds, vectors=cad.vectors,
                 static_swap_rounds=cst.swap_rounds,
                 demoted_rounds=[cst.demoted_rounds, cad.demoted_rounds],
                 final_acc=[cst.final_acc, cad.final_acc])
    if not (churn["adaptive_tta_s"] < churn["static_tta_s"]
            and cad.total_time_s < cst.total_time_s):
        raise AssertionError(f"controller churn: no win: {churn}")
    kernel_cycle = h._cycle_fn
    h._cycle_fn = flrt.make_cycle_fn(h.rt0, loss_fn=h._spec.loss,
                                     opt=h._opt, aggregator="reference")
    try:
        plain = h.run("churn", adaptive=True)
    finally:
        h._cycle_fn = kernel_cycle
    if not (np.array_equal(plain.losses, cad.losses)
            and plain.final_acc == cad.final_acc
            and plain.vectors == cad.vectors):
        raise AssertionError("controller: the plain aggregation diverged "
                             "from the kernel's")
    rec = TraceRecorder()
    traced = h.run("churn", adaptive=True, recorder=rec)
    errors = validate_trace(to_trace_json(rec))
    if errors or not np.array_equal(traced.losses, cad.losses):
        raise AssertionError(f"controller trace: {errors[:5]}")
    return dict(rounds=cfg.rounds, replan_every=cfg.replan_every,
                batch_size=cfg.batch_size,
                samples_per_silo=cfg.samples_per_silo, launches=launches,
                cycle_functions_built=len(built), harness_build_s=build_s,
                host_ms_per_round=host, vec0=h.vec0,
                nominal=dict(final_loss=one.final_loss,
                             final_acc=st.final_acc,
                             total_time_s=st.total_time_s,
                             evaluate_design_equal=True),
                churn=churn, reference_aggregator_equal=True,
                trace=dict(events=len(rec.sim_events) + len(rec.ctrl_events)
                           + len(rec.host_events), valid=True))


def _search_cli() -> dict:
    """(e) `python -m repro_torch.design.search --networks gaia
    --workloads femnist --quick`, cycle and tta objectives: exit 0."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = {}
    for extra in ([], ["--objective", "tta"]):
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "repro_torch.design.search", "--networks",
             "gaia", "--workloads", "femnist", "--quick", *extra], env=env,
            capture_output=True, text=True, timeout=300)
        name = extra[-1] if extra else "cycle"
        if run.returncode:
            raise AssertionError(f"search --quick {name}: rc "
                                 f"{run.returncode}: {run.stderr[-2000:]}")
        out[name] = dict(seconds=time.perf_counter() - t0,
                         stdout=run.stdout.strip().splitlines())
    return out


def phase_design_search(torch, ctx):
    """The design search and the fault controller on the card: (a) the
    paper grid on both grid engines (`_grid_engines`), (b) the scorer's
    candidate rates (`_scorer_rates`), (c) `population_search`
    (`_population`), (d) the controller at its defaults (`_controller`)
    and (e) the search CLI (`_search_cli`). Simulated seconds (cycle
    times, `tta_s`, totals) are the paper's network model's, not the
    card's."""
    _deterministic(torch)
    t_phase = time.perf_counter()
    parts = {}
    for name, fn in (("grid", lambda: _grid_engines(torch)),
                     ("scorer", lambda: _scorer_rates(ctx)),
                     ("population", _population),
                     ("controller", lambda: _controller(torch)),
                     ("cli", _search_cli)):
        t0 = time.perf_counter()
        parts[name] = fn()
        parts[name]["part_s"] = time.perf_counter() - t0
    ctx["launches"]["edge_aggregate_controller"] = \
        parts["controller"]["launches"]
    emit(phase="design_search", ok=True, nvidia_smi=ctx["smi"],
         seconds=time.perf_counter() - t_phase, **parts,
         simulated_note="cycle times, tta_s and totals are simulated "
                        "seconds of the paper's network model, not times "
                        "of the card")


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
    # hd 256 on the wgmma route, in 64-key tiles
    (1, 8, 1, 40, 256, 0, 0, "bfloat16"),     # S under one key tile
    (2, 8, 1, 333, 256, 0, 0, "bfloat16"),    # ragged 64-key tiles
    (1, 14, 2, 300, 256, 0, 0, "bfloat16"),   # G=7: 126 rows a CTA
    (1, 8, 1, 600, 256, 0, 256, "bfloat16"),  # paligemma's mask, four tiles
    (1, 4, 2, 520, 256, 200, 130, "bfloat16"),  # window/prefix across tiles
    (1, 1, 1, 256, 256, 8, 0, "bfloat16"),    # rows masked over whole tiles
]
#: q, k, v as column slices of one fused (B, S, (Hq + 2 Hkv) hd)
#: projection, so q's sequence stride is not Hq hd.
FA_FUSED = (2, 28, 4, 300, 128, 0, 0, "bfloat16")
#: q's rows off the 16-byte grid (a row stride of hd + 4): the CUDA cores
FA_MISALIGNED = (1, 4, 2, 72, 256, 8, 16, "bfloat16")
FA_MAIN = (4, 32, 4, 2048, 128, 0, 0, "bfloat16")   # yi-9b prefill
FA_ZAMBA2 = (4, 32, 32, 2048, 64, 0, 0, "bfloat16")  # zamba2-1.2b prefill
#: paligemma-3b's prefill: MQA with a group of 8, hd 256, prefix 256
FA_PALIGEMMA = (4, 8, 1, 2048, 256, 0, 256, "bfloat16")
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


def device_ms(torch, fn, iters: int, warmup: int = 3,
              name=None) -> float | None:
    """Device time per call under the profiler: all kernels' time, or only
    those whose name contains ``name``. For calls too short to time with
    events: back to back they would measure the host's launch rate. A
    profile that sees no such record is taken again, three times back to
    back, then three times with a synchronise after each call: late in a
    long process the profiler has dropped every record of back-to-back
    short kernels while keeping those of synchronised calls (PERF.md).
    After six blind profiles the reading is None (not measured; the
    callers' CUDA-event times stand) and a line says so."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    seen = []
    for sync_each in (False, False, False, True, True, True):
        with profiled(torch) as prof:
            for _ in range(iters):
                fn()
                if sync_each:
                    torch.cuda.synchronize()
        kernels = device_averages(prof)
        us = sum(ev.self_device_time_total for ev in kernels
                 if name is None or name in ev.key)
        if us > 0:
            return us / 1e3 / iters
        seen.append(len(kernels))
    emit(note="profiler_blind", kernel=name, iters=iters,
         device_events_per_profile=seen)
    return None


def _fa_inputs(torch, case, gen, layout="contiguous"):
    """Seeded q, k, v of ``case``: contiguous, sliced from one fused qkv
    projection (``layout="fused"``), or with q's rows off the 16-byte
    grid (``"misaligned"``: a row stride of hd + 4)."""
    b, hq, hkv, s, hd, _, _, dt = case
    dtype = getattr(torch, dt)
    if layout == "fused":
        qkv = torch.randn((b, s, (hq + 2 * hkv) * hd), generator=gen,
                          device="cuda", dtype=torch.float32).to(dtype)
        return [x.unflatten(-1, (-1, hd)) for x in
                qkv.split((hq * hd, hkv * hd, hkv * hd), dim=-1)]
    pad = 4 if layout == "misaligned" else 0
    q, k, v = [torch.randn((b, s, h, hd + pad), generator=gen,
                           device="cuda", dtype=torch.float32).to(dtype)
               for h in (hq, hkv, hkv)]
    return q[..., :hd], k[..., :hd].contiguous(), v[..., :hd].contiguous()


def _fa_want_route(case, layout="contiguous") -> str:
    """The kernel's route rule for inputs of group <= 128."""
    return ("wgmma" if case[7] == "bfloat16" and case[4] in (64, 128, 256)
            and layout != "misaligned" else "cuda_core")


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


def _fa_keep(torch, s: int, window: int, prefix: int):
    """The (S, S) boolean mask of the (query, key) pairs the kernel
    keeps: causal, the window, the bidirectional prefix."""
    i = torch.arange(s, device="cuda")[:, None]
    j = torch.arange(s, device="cuda")[None, :]
    keep = j <= i
    if window:
        keep &= (i - j) < window
    if prefix:
        keep |= (i < prefix) & (j < prefix)
    return keep


def _fa_sdpa(torch, q, k, v, keep=None):
    """SDPA (the yardstick) on the kernel's inputs: causal, or with the
    boolean mask ``keep``."""
    import torch.nn.functional as F
    mask = dict(is_causal=True) if keep is None else dict(attn_mask=keep)
    return lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        enable_gqa=q.shape[2] != k.shape[2], **mask)


def _fa_bound(ctx, case, pairs=None) -> dict:
    """Work and bytes of one call at ``case`` over ``pairs`` kept (query,
    key) pairs (the causal ones by default), and the least time the card
    could take for it."""
    b, hq, hkv, s, hd = case[:5]
    if pairs is None:
        pairs = s * (s + 1) // 2
    flops = 4 * b * hq * hd * pairs
    nbytes = 2 * (2 * b * s * hq * hd + 2 * b * s * hkv * hd)
    bw, _, rate_key = card_rates(ctx["kind"])
    peak = bf16_peak(ctx["kind"])
    bytes_ms, ops_ms = nbytes / bw * 1e3, flops / peak * 1e3
    return dict(pairs=pairs, flops=flops, bytes=nbytes,
                bound_ms=max(bytes_ms, ops_ms),
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
    for case, layout in ([(c, "contiguous") for c in FA_CASES + [FA_MAIN]]
                         + [(FA_FUSED, "fused"),
                            (FA_MISALIGNED, "misaligned")]):
        q, k, v = _fa_inputs(torch, case, gen, layout)
        win, pre, dt = case[5], case[6], case[7]
        what = (f"flash_attention {case}"
                f"{'' if layout == 'contiguous' else ' ' + layout}")
        routes[what] = ops.route(q, k, v)
        if routes[what] != _fa_want_route(case, layout):
            raise AssertionError(f"{what}: route {routes[what]}, expected "
                                 f"{_fa_want_route(case, layout)}")
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
    paligemma = _fa_masked_row(torch, ctx, FA_PALIGEMMA, gen, 20, fp32=True)
    ctx["flash_attention_paligemma"] = paligemma
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
         zamba2=dict(shape=list(FA_ZAMBA2[:5]), **zamba2),
         paligemma=paligemma)


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


def device_ops_per_call(torch, fn, iters: int = 50) -> tuple:
    """Device operations (kernels, copies, fills) the profiler sees per
    call of ``fn`` in each of three profiles that saw any (a synchronise
    after each call), the names of all of them, and how many profiles
    came back with no device record at all; those are taken again, at
    most five times. The profiler drops the records of short kernels,
    more of them as the process ages (PERF.md), so a reading can fall
    short of the truth; it cannot exceed it."""
    fn()
    torch.cuda.synchronize()
    seen, names, blind = [], set(), 0
    while len(seen) < 3 and blind < 5:
        with profiled(torch) as prof:
            for _ in range(iters):
                fn()
                torch.cuda.synchronize()
        ops = device_averages(prof)
        if not ops:
            blind += 1
            continue
        seen.append(sum(ev.count for ev in ops) / iters)
        names.update(ev.key for ev in ops)
    return seen, names, blind


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
    one device kernel per call: one kernel name in all, and three
    profiles that saw operations, none more than one per call (records
    it drops can only lower a reading; `device_ops_per_call` takes a
    profile that saw none again)."""
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
    seen, names, blind = device_ops_per_call(torch, kernel(q, k, v))
    per_call = max(seen, default=0.0)
    if one_kernel and (len(seen) < 3 or per_call > 1 or len(names) != 1):
        raise AssertionError(f"decode_attention: the profiler saw {seen} "
                             f"device operations per call ({names}; "
                             f"{blind} profiles saw none), not one kernel")
    profiler_ms = device_ms(torch, kernel(q, k, v), 20, name="decode_")
    lib_err = float((sdpa(q, k, v)()[:, :, 0].float()
                     - kernel(q, k, v)().float()).abs().max())
    rows = int(lens_host.sum())            # cache rows this run must read
    esize = q.element_size()
    nbytes = esize * (2 * rows * hkv * hd + 2 * b * hq * hd) + 4 * b
    flops = 4 * rows * hq * hd
    bw, fp32_peak, rate_key = card_rates(ctx["kind"])
    bf16 = q.dtype == torch.bfloat16       # fp32 runs on the CUDA cores
    peak = bf16_peak(ctx["kind"]) if bf16 else fp32_peak
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
        device_ops_per_call_profiles=seen, profiles_without_ops=blind,
        device_ops=sorted(names),
        plain_ms=plain_ms, library_ms=library_ms,
        library_max_abs_diff=lib_err, bound_ms=bound_ms,
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        bound_share=bound_ms / kernel_ms,
        bytes=nbytes, bytes_all_s=esize * 2 * b * s * hkv * hd, flops=flops,
        rates={"card": rate_key, "hbm_bytes_per_s": bw,
               ("bf16" if bf16 else "fp32") + "_flop_per_s": peak},
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
    _timed(ctx, LLM_ARCH, "prefill", b, s, ms)
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


def _decode_run(torch, cfg, params, prompt_lens, new_tokens) -> dict:
    """Eight slots with prompts of ``prompt_lens`` tokens, fed token by
    token as the serving engine's chunked prefill does (slot b starts
    when max(prompt_lens) - len_b steps have passed, so every prompt ends
    on the same step and the per-slot positions differ throughout), then
    ``new_tokens`` greedy tokens, through `make_serve_step`; the caches
    take the weights' type. The kernel run picks the tokens; a
    `decode_step(impl="reference")` run is fed the same tokens, so the
    two runs' logits compare step by step. Counts `decode_attention`
    launches per step (one per layer expected) and keeps the lengths of
    an early step, the last prompt token and the last step."""
    import numpy as np
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import transformer as tf

    serve = make_serve_step(cfg)
    nb = DECODE_SLOTS
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in prompt_lens]
    last = max(prompt_lens) - 1     # the step of every last prompt token
    start = [last + 1 - n for n in prompt_lens]
    steps = last + new_tokens
    check_at = {min(20, last // 2): "early", last: "last_prompt",
                steps - 1: "generating"}
    dt = params["embed"]["tok"].dtype
    st_k, st_r = (tf.init_decode_state(cfg, nb, DECODE_MAX_SEQ, dtype=dt,
                                       device="cuda") for _ in range(2))
    out = [[] for _ in range(nb)]
    lens_at, rels, step_s, ref_s, off = {}, [], [], [], []
    agree, cross = 0, None
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
                off.append((t, ops.decode_attention.launches - before))
            t0 = time.perf_counter()
            lr, st_r = tf.decode_step(params, cfg, tokens, st_r,
                                      impl="reference")
            nxt_r = lr[:, 0].argmax(-1).cpu()
            ref_s.append(time.perf_counter() - t0)
            active = [i for i in range(nb) if t >= start[i]]
            if not torch.isfinite(lk[active]).all():
                raise AssertionError(f"{cfg.name}: non-finite decode logits "
                                     f"at step {t}")
            rels.append(_rel_l2(lk[active], lr[active]))
            if t == last:
                cross = lk[nb - 1, 0].float().clone()
            if t >= last:
                agree += int((nxt == nxt_r).sum())
                for i in range(nb):
                    out[i].append(int(nxt[i]))
    return dict(serve=serve, state=st_k, prompts=prompts, out=out,
                lens_at=lens_at, cross=cross, last=last, steps=steps,
                launches=ops.decode_attention.launches, launches_off=off,
                rels=rels, step_s=step_s, ref_s=ref_s,
                agree=agree / (nb * new_tokens))


def phase_llm_decode(torch, ctx):
    """`_decode_run` on yi-9b with prompts of DECODE_PROMPTS tokens and
    DECODE_NEW greedy tokens; the kernel on the run's own caches
    (`_decode_live_check`, which sets its `kernels` row), a profile of a
    few more steps, and the last slot's logits at its last prompt token
    against the prefill step on that prompt."""
    from repro_torch.launch.steps import make_prefill_step

    cfg, params = _llm(torch, ctx)
    nb = DECODE_SLOTS
    run = _decode_run(torch, cfg, params, DECODE_PROMPTS, DECODE_NEW)
    serve, st_k, out = run["serve"], run["state"], run["out"]
    steps, last, step_s = run["steps"], run["last"], run["step_s"]
    launches = run["launches"]
    ctx["launches"]["decode_attention"] = launches
    if run["launches_off"]:
        raise AssertionError(f"decode_attention launched (step, times) "
                             f"{run['launches_off']}, not once per layer")
    with torch.inference_mode():
        # the kernel against its plain version on the live caches at the
        # schedule's lengths (these launches are not the path's)
        live = _decode_live_check(torch, ctx, cfg, st_k.caches["kv"][0],
                                  run["lens_at"])
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
            "tokens": torch.as_tensor(run["prompts"][nb - 1],
                                      device="cuda")[None]})
    cross_rel = _rel_l2(run["cross"], pre[0])
    rels = run["rels"]
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
         reference_ms_per_step=1e3 * sum(run["ref_s"]) / steps,
         weight_floor_ms=floor_ms, logits_rel_l2_max=worst,
         logits_rel_l2_mean=sum(rels) / len(rels),
         greedy_same_share=run["agree"],
         decode_vs_prefill_rel_l2=cross_rel, rel_tol=LOGITS_REL_TOL,
         sample_tokens=out[nb - 1][:8], decode_attention_main_path=live,
         profile=profile)
    del params, st_k, holder, run  # yi-9b's weights stay for phase sharded
    torch.cuda.empty_cache()


#: Phase sharded: prompt tokens fed one by one, then greedy tokens.
SHARDED_DECODE = (16, 8)
SHARDED_TIMED_RUNS = 3


@contextlib.contextmanager
def _one_rank_mesh(torch):
    """A one-rank NCCL world and its (1, 1) ("data", "model") DeviceMesh,
    destroyed on exit."""
    import socket

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        yield make_debug_mesh((1, 1), ("data", "model"))
    finally:
        dist.destroy_process_group()


def _best_ms(torch, fn, runs: int = SHARDED_TIMED_RUNS) -> float:
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return min(times) * 1e3


def phase_sharded(torch, ctx):
    """The sharded LLM program on the card: yi-9b at full width and depth
    in bf16, its weights DTensors under the production specs
    (`launch/sharding.param_specs`) on a one-rank NCCL (1, 1) ("data",
    "model") mesh. (a) Prefill at PREFILL_SHAPE with the activation
    anchors set and impl="kernel": one `flash_attention` launch a layer,
    all on the wgmma route, run on the rank's head shard (the attention's
    `local_map`); the logits bit-equal to the unsharded prefill of the
    same weights; both timed, the difference being DTensor's host work.
    (b) Decode of DECODE_SLOTS slots, SHARDED_DECODE prompt and greedy
    tokens, the caches DTensors under `decode_cache_specs`: one
    `decode_attention` launch a layer a step, the same tokens and
    bit-equal logits as the unsharded step, ms a step of both. (c) The
    sequence-sharded cache layout (kv_seq_shard) on the kernel route
    raises. The dry runs of the sharded program are read by
    `phase_sharded_host`."""
    import numpy as np
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import shard_ctx
    from repro_torch.models import transformer as tf

    cfg, params = _llm(torch, ctx)
    P = sh.P
    b, s = PREFILL_SHAPE
    tokens = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (b, s)), device="cuda")
    prefill = make_prefill_step(cfg, impl="kernel")
    serve = make_serve_step(cfg, impl="kernel")
    nb = DECODE_SLOTS
    n_prompt, n_new = SHARDED_DECODE
    prompts = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (nb, n_prompt)), device="cuda")
    failures = []
    with _one_rank_mesh(torch) as mesh, torch.no_grad(), \
            implicit_replication():
        dparams = sh.shard_tree(params, mesh,
                                sh.param_specs(cfg, params, mesh=mesh))
        dtokens = sh.shard_of(tokens, mesh, P("data", None))
        # (a) prefill
        shard_ctx.set_specs(act=P("data", None, None),
                            channels=P("data", None, "model"),
                            heads=P("data", None, "model", None), mesh=mesh)
        try:
            fa_ops.flash_attention.launches = 0
            fa_ops.flash_attention.launches_by_route.update(wgmma=0,
                                                            cuda_core=0)
            got = prefill(dparams, {"tokens": dtokens})
            torch.cuda.synchronize()
            fa_launches = fa_ops.flash_attention.launches
            routes = dict(fa_ops.flash_attention.launches_by_route)
            got = got.full_tensor()
            sharded_ms = _best_ms(torch, lambda: prefill(
                dparams, {"tokens": dtokens}))
        finally:
            shard_ctx.clear()
        want = prefill(params, {"tokens": tokens})
        plain_ms = _best_ms(torch, lambda: prefill(params,
                                                   {"tokens": tokens}))
        ctx["launches"]["flash_attention_sharded"] = fa_launches
        pre = dict(flash_attention_launches=fa_launches, routes=routes,
                   logits_bit_equal=bool(torch.equal(got, want)),
                   logits_rel_l2=_rel_l2(got, want),
                   logits_max_abs_diff=float((got.float()
                                              - want.float()).abs().max()),
                   ms_sharded=sharded_ms, ms_unsharded=plain_ms,
                   dtensor_host_ms=sharded_ms - plain_ms)
        if fa_launches != cfg.num_layers or routes["wgmma"] != fa_launches:
            failures.append(f"prefill: flash_attention launches {routes}, "
                            f"want {cfg.num_layers} on wgmma")
        if not pre["logits_bit_equal"]:
            failures.append(f"prefill logits differ from the unsharded "
                            f"step: {pre}")
        del got, want
        # (b) decode
        states = [tf.init_decode_state(cfg, nb, DECODE_MAX_SEQ,
                                       dtype=torch.bfloat16, device="cuda")
                  for _ in range(2)]
        specs = sh.decode_cache_specs(cfg, states[1], batch=nb,
                                      multi_pod=False, mesh=mesh)
        st_p, st_s = states[0], sh.shard_tree(states[1], mesh, specs)
        da_ops.decode_attention.launches = 0
        off, same, bit, ms_s, ms_p = [], True, True, [], []
        tok = prompts[:, :1]
        for t in range(n_prompt + n_new):
            before = da_ops.decode_attention.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg_s, st_s = serve(dparams, sh.shard_of(tok, mesh,
                                                    P("data", None)), st_s)
            lg_s = lg_s.full_tensor()
            torch.cuda.synchronize()
            ms_s.append((time.perf_counter() - t0) * 1e3)
            if da_ops.decode_attention.launches - before != cfg.num_layers:
                off.append((t, da_ops.decode_attention.launches - before))
            n_launch = da_ops.decode_attention.launches
            t0 = time.perf_counter()
            lg_p, st_p = serve(params, tok, st_p)
            torch.cuda.synchronize()
            ms_p.append((time.perf_counter() - t0) * 1e3)
            da_ops.decode_attention.launches = n_launch
            nxt_s, nxt_p = lg_s[:, -1].argmax(-1), lg_p[:, -1].argmax(-1)
            same &= bool(torch.equal(nxt_s, nxt_p))
            bit &= bool(torch.equal(lg_s, lg_p))
            tok = (prompts[:, t + 1:t + 2] if t + 1 < n_prompt
                   else nxt_p[:, None])
        steps = n_prompt + n_new
        ctx["launches"]["decode_attention_sharded"] = \
            da_ops.decode_attention.launches
        dec = dict(steps=steps, slots=nb,
                   decode_attention_launches=da_ops.decode_attention.launches,
                   launches_off=off, tokens_equal=same, logits_bit_equal=bit,
                   ms_per_step_sharded=sum(ms_s[1:]) / (steps - 1),
                   ms_per_step_unsharded=sum(ms_p[1:]) / (steps - 1),
                   cache_placements=[str(p) for p in
                                     st_s.caches["kv"][0]["k"].placements])
        if off or not same or not bit:
            failures.append(f"decode: {dec}")
        del states, st_p, st_s
        torch.cuda.empty_cache()
        # (c) the sequence-sharded layout on the kernel route
        small = tf.init_decode_state(cfg, nb, 64, dtype=torch.bfloat16,
                                     device="cuda")
        seq = sh.shard_tree(small, mesh, sh.decode_cache_specs(
            cfg, small, batch=nb, multi_pod=False, mesh=mesh,
            kv_seq_shard=True))
        try:
            serve(dparams, sh.shard_of(prompts[:, :1], mesh,
                                       P("data", None)), seq)
            refusal = None
            failures.append("the kernel route decoded a sequence-sharded "
                            "cache")
        except ValueError as exc:
            refusal = str(exc)
        del dparams, small, seq
    del ctx["llm"], params
    torch.cuda.empty_cache()
    emit(phase="sharded", ok=not failures, arch=cfg.name,
         layers=cfg.num_layers, mesh=[1, 1], nvidia_smi=ctx["smi"],
         prefill=dict(batch=b, seq=s, **pre), decode=dec,
         kernel_refuses_sequence_sharding=refusal, failures=failures)
    if failures:
        raise AssertionError(f"sharded: {failures}")


def phase_sharded_host(torch, ctx):
    """The sharded program's dry runs, run by `start_host_work` beside the
    card phases: `python -m repro_torch.launch.dryrun` on
    SHARDED_DRYRUN_CLI (yi-9b x train_4k on a fake (16, 16) world) exits
    0 with a report whose collectives are not empty, and `fl8`'s dry
    states order their pod-axis bytes overlay > half > isolated = 0."""
    del torch
    cli = host_result(ctx, "dryrun_sharded")
    path = (Path(ctx["host_work"]["tmp"]) / "sharded"
            / "h100x256__yi-9b__train_4k.json")
    rep = json.loads(path.read_text()) if path.exists() else {}
    states = {r["state"]: r for r in host_result(ctx, "fl8_dry")}
    pod = {k: r["pod_permute_bytes"] for k, r in states.items()}
    failures = []
    if cli["rc"] or rep.get("status") != "ok" or \
            not rep["collectives"]["total_bytes"]:
        failures.append(f"sharded dry run: rc {cli['rc']}, "
                        f"{rep.get('status')}, {cli['stderr_tail']}")
    if not pod["overlay"] > pod["half"] > pod["isolated"] == 0:
        failures.append(f"fl8 dry pod bytes {pod}")
    emit(phase="sharded_host", ok=not failures,
         dryrun=dict(rc=cli["rc"], seconds=cli["seconds"],
                     mesh_shape=rep.get("mesh_shape"),
                     collectives=rep.get("collectives"),
                     memory=rep.get("memory"), trace_s=rep.get("trace_s")),
         fl8_dry={k: dict(pod_permute_bytes=r["pod_permute_bytes"],
                          shard_bytes=r["shard_bytes"],
                          collectives=r["collectives"])
                  for k, r in states.items()},
         failures=failures)
    if failures:
        raise AssertionError(f"sharded_host: {failures}")


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
    fn()
    torch.cuda.synchronize()
    with profiled(torch) as prof:
        for _ in range(iters):
            fn()
    out: dict = {}
    for ev in device_averages(prof):
        m = re.search(rf"({stem}\w*)", ev.key)
        if m:
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
    _timed(ctx, arch, "prefill", b, s, ms)
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


# ---------------------------------------------------------------------------
# serving: the slot engine with its decode step captured as one CUDA graph,
# the regional fleet over an FL checkpoint, the traffic sweep and the CLI
# ---------------------------------------------------------------------------

#: engine steps whose logits the eager and the captured engine compare: a
#: prompt step, the first wave's last prompt step, a generating step
SERVE_PROBES = (20, 127, 150)
#: steady engine steps profiled, from SERVE_PROFILE_AT on
SERVE_PROFILE_AT, SERVE_PROFILE_STEPS = 40, 4
#: the fleet: reduced yi-9b (fp32, hd 32) on gaia's 11 silos, the CLI's
#: slots and max_seq, the reference CLI's loads
FLEET_SILOS, FLEET_SLOTS, FLEET_SEQ = 11, 4, 64
FLEET_LOADS = (20.0, 60.0, 120.0)
FLEET_TRAFFIC = dict(duration_ms=1000.0, step_ms=10.0)


def _requests(prompts, new_tokens):
    from repro_torch.serving import Request
    return [Request(prompt=[int(t) for t in p], max_new_tokens=new_tokens)
            for p in prompts]


def _drive(torch, engine, requests, *, profile=False) -> dict:
    """Submit ``requests`` and step ``engine`` until every one completes,
    timing each step on the host clock (a step ends with the sampled
    tokens' copy to the host). With ``profile``, SERVE_PROFILE_STEPS steps
    from SERVE_PROFILE_AT on run under the profiler, again on the next
    steps when a profile saw no device record (at most five times); they
    are left out of the times."""
    for r in requests:
        engine.submit(r)
    times, prof, blind = [], None, 0
    while engine.queue or any(not s.free for s in engine.slots):
        if (profile and prof is None and blind < 5
                and len(times) >= SERVE_PROFILE_AT):
            torch.cuda.synchronize()
            with profiled(torch) as p:
                for _ in range(SERVE_PROFILE_STEPS):
                    engine.step()
            ev = device_averages(p)
            if not ev:
                blind += 1
                continue
            n = SERVE_PROFILE_STEPS
            kern = sorted(((e.self_device_time_total, e.key, e.count)
                           for e in ev), reverse=True)
            prof = dict(
                steps=n, device_busy_ms=sum(k[0] for k in kern) / 1e3 / n,
                device_ops_per_step=sum(k[2] for k in kern) / n,
                decode_attention_per_step=sum(
                    k[2] for k in kern if "decode_attn" in k[1]) / n,
                top_kernels=[dict(kernel=k[1][:90], device_ms=k[0] / 1e3 / n,
                                  calls=k[2] / n) for k in kern[:6]],
                profiles_without_ops=blind)
            continue
        t0 = time.perf_counter()
        engine.step()
        times.append(time.perf_counter() - t0)
    if profile and prof is None:
        raise AssertionError(f"the profiler saw no device record in {blind} "
                             "profiles of the captured step")
    steady = times[2:]
    ms = 1e3 * sum(steady) / len(steady)
    out = dict(steps=engine.steps, timed_steps=len(times),
               run_s=sum(times), ms_per_step=ms,
               ms_per_step_median=1e3 * sorted(steady)[len(steady) // 2],
               first_steps_ms=[1e3 * t for t in times[:2]],
               # generated tokens a step at the steady step rate
               tokens_per_s=sum(len(r.output) for r in requests)
               / engine.steps * 1e3 / ms)
    if prof is not None:
        prof["idle_share"] = max(0.0, 1 - prof["device_busy_ms"]
                                 / out["ms_per_step"])
        out["profile"] = prof
    return out


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone_tree(v) for v in tree]
    return tree.clone()


def _host_positions_check(torch, cfg, params, engine) -> dict:
    """The captured step (positions kept on the card, unchecked there)
    replayed once more on the engine's live caches and positions, against
    `make_serve_step`'s step with the same positions read on the host
    (range-checked, uploaded) on a copy of the same caches: logits and
    caches bit-equal. This replay is a check, not a step of the engine."""
    import numpy as np

    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import transformer as tf
    from repro_torch.serving.engine import _cache_leaves
    pos = torch.from_numpy(engine.positions.copy())
    tok = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab_size, engine.max_slots))
    copy = _clone_tree(engine.caches)
    host, _ = make_serve_step(cfg)(params, tok[:, None].cuda(),
                                  tf.DecodeState(caches=copy, position=pos))
    engine._dev_in.copy_(torch.stack([tok, pos]))
    engine._graph.replay()
    torch.cuda.synchronize()
    diff = float((host.float() - engine._logits.float()).abs().max())
    caches_equal = all(torch.equal(a, b) for a, b in zip(
        _cache_leaves(copy), _cache_leaves(engine.caches)))
    if diff != 0.0 or not caches_equal:
        raise AssertionError(f"{cfg.name}: the captured step with positions "
                             f"{pos.tolist()} on the card is {diff} off the "
                             "host-position step (caches equal: "
                             f"{caches_equal})")
    return dict(positions=pos.tolist(), logits_max_abs_diff=diff,
                caches_equal=True)


def _engine_pair(torch, ctx, cfg, params, prompts, kv, alone: int,
                 label: str) -> tuple:
    """The same requests (DECODE_NEW tokens each) through an eager engine
    (`cuda_graph=False`) and a captured one, bf16, DECODE_SLOTS slots,
    DECODE_MAX_SEQ; ``kv(engine)`` gives the stacked caches the
    attention layers read. Tokens equal request for request, one
    capture, the profiler's `decode_attention` kernels per replay
    (`want` = the attention layers), logits at SERVE_PROBES, the kernel
    on the captured engine's live caches against its plain version and
    timed there, the captured step against the host-position step
    (`_host_positions_check`), then request ``alone`` served alone after
    a `reset()`: the same tokens as in the batch."""
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.engine import WARMUP_STEPS
    probes = {"eager": {}, "graph": {}}

    def sampler(name):
        calls = [0]

        def sample(logits):
            if calls[0] in SERVE_PROBES:
                probes[name][calls[0]] = logits.float().clone()
            calls[0] += 1
            return torch.argmax(logits, -1)
        return sample

    kw = dict(max_slots=DECODE_SLOTS, max_seq=DECODE_MAX_SEQ,
              dtype=torch.bfloat16, device="cuda")
    eager = ServingEngine(cfg, params, cuda_graph=False,
                         sample=sampler("eager"), **kw)
    want = kv(eager)["k"].shape[0]
    e_reqs = _requests(prompts, DECODE_NEW)
    dec.decode_attention.launches = 0
    e_run = _drive(torch, eager, e_reqs)
    eager_launches = dec.decode_attention.launches
    del eager
    graph = ServingEngine(cfg, params, sample=sampler("graph"), **kw)
    g_reqs = _requests(prompts, DECODE_NEW)
    dec.decode_attention.launches = 0
    g_run = _drive(torch, graph, g_reqs, profile=True)
    wrapper = dec.decode_attention.launches
    per_replay = g_run["profile"]["decode_attention_per_step"]
    if per_replay != want:
        raise AssertionError(f"{cfg.name}: the profiler saw {per_replay} "
                             f"decode_attention kernels a replay, not "
                             f"{want}")
    if wrapper != (WARMUP_STEPS + 1) * want or graph.captures != 1:
        raise AssertionError(f"{cfg.name}: {graph.captures} captures, "
                             f"{wrapper} wrapper calls")
    same = sum(a.output == b.output for a, b in zip(e_reqs, g_reqs))
    if same != len(prompts):
        raise AssertionError(f"{cfg.name}: captured tokens differ from "
                             f"eager in {len(prompts) - same} of "
                             f"{len(prompts)} requests")
    probe_diff = {k: float((probes["eager"][k] - probes["graph"][k])
                           .abs().max()) for k in probes["graph"]}
    lens = torch.clamp(torch.from_numpy(graph.positions + 1),
                       max=DECODE_MAX_SEQ).to(torch.int32)
    live = _decode_live_check(torch, ctx, cfg, kv(graph),
                              {"generating": lens}, label=label, row=False)
    host_positions = _host_positions_check(torch, cfg, params, graph)
    graph.reset()
    solo = _requests([prompts[alone]], DECODE_NEW)
    graph.submit(solo[0])
    graph.run()
    if solo[0].output != g_reqs[alone].output or graph.captures != 1:
        raise AssertionError(f"{cfg.name}: request {alone} alone gave "
                             "other tokens than in the batch, or the "
                             f"engine captured again ({graph.captures})")
    launches = wrapper - want + graph.steps * want  # want == per_replay
    del graph
    torch.cuda.empty_cache()
    row = dict(launches=launches,
               max_abs_err=max(live["max_abs_diff"].values()),
               ms=live["kernel_ms"], plain_ms=live["plain_ms"],
               bound_ms=live["bound_ms"], bound_by=live["bound_by"],
               library_ms=live["library_ms"])
    return dict(
        requests=len(prompts), prompt_lengths=[len(p) for p in prompts],
        new_tokens=DECODE_NEW, slots=DECODE_SLOTS, max_seq=DECODE_MAX_SEQ,
        tokens_equal=same, alone_request=alone, alone_equal=True,
        captures=1, eager=e_run, captured=g_run,
        speedup=e_run["ms_per_step"] / g_run["ms_per_step"],
        eager_decode_attention_launches=eager_launches,
        decode_attention_per_replay=per_replay,
        decode_attention_launches=launches, replays_note=(
            "launches = wrapper calls (warm-up steps and the capture) - "
            "the capture's + steps (replays) x kernels a replay"),
        logits_max_abs_diff_at_probes=probe_diff,
        host_positions_check=host_positions,
        weight_floor_ms=_param_bytes(params) / card_rates(ctx["kind"])[0]
        * 1e3, decode_attention_live=live), row


def _fleet_checkpoint(torch, ckpt_dir) -> dict:
    """An FL checkpoint of reduced yi-9b on gaia's 11 silos, as
    launch/train.py writes one: rows drawn around one `init_params` from
    a seeded generator, the trainer's metadata."""
    from repro_torch.checkpoint import CheckpointManager, save_fl_checkpoint
    from repro_torch.configs import get_config, reduce
    from repro_torch.fl import flat
    from repro_torch.models import transformer as tf
    cfg = reduce(get_config(LLM_ARCH))
    gen = torch.Generator().manual_seed(0)
    params = tf.init_params(cfg, gen, device="cpu")
    base = flat.ravel(flat.make_flat_spec(params), params)
    rows = base[None] + 0.01 * torch.randn((FLEET_SILOS, base.numel()),
                                           generator=gen)
    meta = dict(round=6, arch="yi-9b", network="gaia",
                dataset="synthetic-lm", workload="femnist",
                topology="multigraph", t=2, seed=0, num_silos=FLEET_SILOS,
                lora_rank=0, params_kind="full", seq_len=16, lr=1e-3,
                sim_time_ms=1234.5, loss_tail=[])
    save_fl_checkpoint(CheckpointManager(ckpt_dir), 6, rows, **meta)
    return dict(arch=cfg.name, rows=list(rows.shape), step=6)


def _fleet(torch, ctx, ckpt_dir) -> tuple:
    """`RegionalFleet.from_checkpoint` on the card and on the CPU,
    `sweep_loads` at FLEET_LOADS one load a call (timed) on each: the
    summaries equal dict for dict, the loads nested, p99 monotone, one
    capture per region engine; the tokens of card and CPU compared
    request for request; `decode_attention` on a region engine's live
    caches (fp32, hd 32) against its plain version and timed there."""
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.serving import (RegionalFleet, Request, TrafficConfig,
                                     generate_requests, sweep_loads)
    from repro_torch.serving.engine import WARMUP_STEPS
    cfg = TrafficConfig(**FLEET_TRAFFIC)
    out, results, tokens, fleets = {}, {}, {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        fleets[dev] = fleet = RegionalFleet.from_checkpoint(
            ckpt_dir, max_slots=FLEET_SLOTS, max_seq=FLEET_SEQ, device=dev)
        build_s = time.perf_counter() - t0
        dec.decode_attention.launches = 0
        walls, results[dev], tokens[dev] = [], [], []
        for load in FLEET_LOADS:
            t0 = time.perf_counter()
            results[dev] += sweep_loads(fleet, cfg, [load])
            walls.append(time.perf_counter() - t0)
            tokens[dev] += [req.output for reg in fleet.regions.values()
                            for req in reg.engine.completed]
        steps = sum(r.engine.steps for r in fleet.regions.values())
        out[dev] = dict(build_s=build_s, wall_s_per_load=walls,
                        engine_steps=steps,
                        ms_per_engine_step=1e3 * sum(walls) / steps)
        if dev == "cuda":
            wrapper = dec.decode_attention.launches
    card = fleets["cuda"]
    cfg_m = next(iter(card.regions.values())).engine.cfg
    layers = cfg_m.num_layers
    caps = {r: v.engine.captures for r, v in card.regions.items()}
    if set(caps.values()) != {1} or wrapper != (WARMUP_STEPS + 1) * layers \
            * len(caps):
        raise AssertionError(f"fleet: captures {caps}, {wrapper} wrapper "
                             "calls")
    summaries = {dev: [r.summary for r in res] for dev, res in
                 results.items()}
    if summaries["cuda"] != summaries["cpu"]:
        raise AssertionError("fleet: card and CPU summaries differ: "
                             f"{summaries}")
    keys = [{(r.t_gen, r.site) for r in generate_requests(card, cfg, ld)}
            for ld in FLEET_LOADS]
    p99 = [s["p99_ms"] for s in summaries["cuda"]]
    if not (keys[0] <= keys[1] <= keys[2]) or p99 != sorted(p99) \
            or any(s["completed"] != s["arrived"] for s in
                   summaries["cuda"]):
        raise AssertionError(f"fleet: loads not nested, p99 {p99} not "
                             "monotone, or a load did not drain")
    agree = sum(a == b for a, b in zip(tokens["cuda"], tokens["cpu"]))
    # the kernel on the live caches of the first region's engine
    eng = next(iter(card.regions.values())).engine
    kv = eng.caches["kv"][0]
    lens = torch.clamp(torch.from_numpy(eng.positions + 1),
                       max=FLEET_SEQ).to(torch.int32)
    gen = torch.Generator(device="cuda").manual_seed(9)
    sets, errs = [], []
    for i in range(layers):
        q = torch.randn((FLEET_SLOTS, cfg_m.num_heads, cfg_m.head_dim),
                        generator=gen, device="cuda")
        got = dec.decode_attention(q, kv["k"][i], kv["v"][i], lens)
        errs.append(_compare(torch, got, _dec_plain(q, kv["k"][i],
                                                    kv["v"][i], lens),
                             "float32", f"decode_attention, fleet layer {i}"))
        sets.append((q, kv["k"][i], kv["v"][i]))
    timing = _decode_timing(torch, ctx, sets, lens)
    # the kernels a replay, from the profiler, on one more request (these
    # replays are not the sweep's)
    eng.submit(Request(prompt=[1] * 8, max_new_tokens=8))
    seen = []
    for _ in range(3):
        before = eng.steps
        with profiled(torch) as p:
            for _ in range(4):
                eng.step()
        n = sum(e.count for e in device_averages(p)
                if "decode_attn" in e.key)
        if n:
            seen.append(n / (eng.steps - before))
            break
    if seen != [layers]:
        raise AssertionError(f"fleet: the profiler saw {seen} decode_attention"
                             f" kernels a replay, not {layers}")
    launches = wrapper - layers * len(caps) + out["cuda"]["engine_steps"] \
        * layers
    row = dict(launches=launches, max_abs_err=max(errs),
               ms=timing["kernel_ms"], plain_ms=timing["plain_ms"],
               bound_ms=timing["bound_ms"], bound_by=timing["bound_by"],
               library_ms=timing["library_ms"])
    del card, fleets, fleet, eng, kv, sets
    return dict(arch=cfg_m.name, regions=list(caps), captures=caps,
                loads=list(FLEET_LOADS), traffic=FLEET_TRAFFIC,
                slots=FLEET_SLOTS, max_seq=FLEET_SEQ, summaries=summaries[
                    "cuda"], summaries_equal=True, p99_ms=p99,
                tokens_agree=agree, requests=len(tokens["cuda"]),
                decode_attention_per_replay=layers,
                decode_attention_launches=launches,
                card=out["cuda"], cpu=out["cpu"],
                decode_attention_fleet_shape=dict(max_abs_diff=errs,
                                                  **timing)), row


def _serving_cli(torch, tmp: Path) -> dict:
    """`python -m repro_torch.serving --skip-train` on the fleet's
    checkpoint (exit 0, every load drained), `python -m repro_torch.obs
    validate` of its bench and trace (exit 0), and the CLI with --mesh 2
    --lora-rank 4: trains LoRA deltas on two stacked shards, then serves
    the `lora_delta` checkpoint it wrote (exit 0, every load drained)."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    bench, trace = tmp / "BENCH_torch_serving.json", tmp / "serve.json"

    def run(*args):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", *args], env=env, cwd=tmp,
                           capture_output=True, text=True, timeout=600)
        return r, time.perf_counter() - t0

    serve, serve_s = run("repro_torch.serving", "--skip-train", "--ckpt-dir",
                         str(tmp / "ckpt"), "--loads", "20,60", "--bench",
                         str(bench), "--trace", str(trace))
    if serve.returncode != 0:
        raise AssertionError(f"serving CLI exit {serve.returncode}: "
                             f"{serve.stderr[-2000:]}")
    rows = json.loads(serve.stdout)["serve"]
    if len(rows) != 2 or any(s["completed"] != s["arrived"] for s in rows):
        raise AssertionError(f"serving CLI rows: {rows}")
    check, _ = run("repro_torch.obs", "validate", str(trace), "--bench",
                   str(bench))
    lora, lora_s = run("repro_torch.serving", "--mesh", "2", "--lora-rank",
                       "4", "--ckpt-dir", str(tmp / "lora"), "--loads", "20")
    if check.returncode != 0 or lora.returncode != 0:
        raise AssertionError(f"validate exit {check.returncode} "
                             f"({check.stdout[-500:]}), --mesh 2 --lora-rank "
                             f"4 exit {lora.returncode} "
                             f"({lora.stderr[-1000:]})")
    lora_out = json.loads(lora.stdout)
    meta = json.loads(subprocess.run(
        [sys.executable, "-c", "import json; from repro_torch.checkpoint "
         "import load_fl_checkpoint as l; print(json.dumps(l("
         f"{str(tmp / 'lora')!r}).meta))"], env=env, capture_output=True,
        text=True, timeout=300, check=True).stdout)
    if meta.get("params_kind") != "lora_delta" or any(
            s["completed"] != s["arrived"] for s in lora_out["serve"]):
        raise AssertionError(f"--mesh 2 --lora-rank 4: {meta}, "
                             f"{lora_out['serve']}")
    return dict(serve_exit=0, serve_s=serve_s, serve_rows=rows,
                validate_exit=0, mesh_lora_exit=0, mesh_lora_s=lora_s,
                mesh_lora_train=lora_out["train"],
                mesh_lora_serve=lora_out["serve"])


def phase_serving(torch, ctx):
    import tempfile

    import numpy as np
    t_phase = time.perf_counter()
    rng = np.random.default_rng(10)
    cfg, params = _llm(torch, ctx)
    prompts = [rng.integers(0, cfg.vocab_size, n)
               for n in DECODE_PROMPTS * 2]
    yi, yi_row = _engine_pair(torch, ctx, cfg, params, prompts,
                              lambda e: e.caches["kv"][0], alone=8,
                              label="layer")
    del ctx["llm"], params
    torch.cuda.empty_cache()
    cfg, params, _ = _ssm_model(torch, ctx, SSM_ARCHS["hybrid"])
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in DECODE_PROMPTS]
    zamba, zamba_row = _engine_pair(torch, ctx, cfg, params, prompts,
                                    lambda e: e.caches["shared_kv"], alone=0,
                                    label="application")
    ctx.pop("ssm_model", None)
    del params
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ckpt = _fleet_checkpoint(torch, tmp / "ckpt")
        fleet, fleet_row = _fleet(torch, ctx, tmp / "ckpt")
        cli = _serving_cli(torch, tmp)
    ctx["serving_rows"] = [
        dict(path=f"serving: the yi-9b engine, {len(DECODE_PROMPTS) * 2} "
             f"requests through {DECODE_SLOTS} slots, captured",
             **yi_row),
        dict(path=f"serving: the zamba2-1.2b engine, {len(DECODE_PROMPTS)} "
             "requests, captured", **zamba_row),
        dict(path=f"serving: the reduced yi-9b fleet on gaia "
             f"({len(fleet['regions'])} region engines, fp32, hd 32), "
             f"sweep_loads at {list(FLEET_LOADS)}", **fleet_row)]
    emit(phase="serving", ok=True, seconds=time.perf_counter() - t_phase,
         yi_9b=yi, zamba2=zamba, fleet_checkpoint=ckpt, fleet=fleet,
         cli=cli)


# ---------------------------------------------------------------------------
# llm_families and llm_train: the moe, vlm and audio families, gemma3's
# mixed prefill, and LLM training
# ---------------------------------------------------------------------------

#: The families run at full width and depth: granite-moe (moe), paligemma
#: (vlm, hd 256, MQA), musicgen (audio) and gemma3 (the mixed local/global
#: stack), each with its attention layers.
FAMILY_ARCHS = ("granite_moe_1b", "paligemma_3b", "musicgen_large",
                "gemma3_27b")
FAMILY_PROMPTS = (2, 4, 6, 8, 10, 12, 14, 16)   # one length per slot
FAMILY_NEW = 32                                 # greedy tokens per slot
#: relative L2 limits of the families' logits, kernel path against
#: impl="reference" on the same weights (prefill and decode; PERF.md §2),
#: in bf16 and, for FAMILY_FP32, with both paths in fp32. The dense-like
#: three keep yi-9b's 5e-2 (readings 0.017-0.027 on an H100). Random
#: granite-moe weights in bf16 are chaotic: the experts' 1/sqrt(E) init
#: scale (the reference's) grows the residual stream by about 100 a layer,
#: and the two paths' bf16 roundings flip near-tied top-8 routing choices,
#: so its bf16 logits read 0.94 / 0.92 apart (prefill / decode) while the
#: same weights in fp32 read 2.8e-5 / 5.4e-6; its limits are about twice
#: each largest reading, and only the fp32 one is tight.
FAMILY_LOGITS_REL_TOL = {arch: {"bf16": LOGITS_REL_TOL}
                         for arch in FAMILY_ARCHS}
FAMILY_LOGITS_REL_TOL["granite_moe_1b"] = {"bf16": 2.0, "fp32": 1e-4}
#: models also compared in fp32 (weights cast from bf16, exactly)
FAMILY_FP32 = ("granite_moe_1b",)
FAMILY_REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:104",
    "decode_attention": "src/repro/kernels/decode_attention/kernel.py:75"}


def _fa_family_case(cfg, window: int = 0, prefix: int = 0) -> tuple:
    """A family's prefill attention as a flash_attention case (bf16)."""
    b, s = PREFILL_SHAPE
    return (b, cfg.num_heads, cfg.num_kv_heads, s, cfg.head_dim, window,
            prefix, "bfloat16")


def _fa_masked_row(torch, ctx, case, gen, iters: int,
                   fp32: bool = False) -> dict:
    """`flash_attention` at ``case`` (bf16, causal, its window and prefix)
    on seeded random inputs: on the rule's route, against its plain
    version within `_tol` (with ``fp32`` also within FP32_ROW_REL_TOL per
    row of the plain version run in fp32), timed over ``iters`` calls
    beside the plain version, SDPA with the same boolean mask (a
    yardstick the port never calls) and the bound for the (query, key)
    pairs the mask keeps."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    b, hq, hkv, s, hd, window, prefix, dt = case
    q, k, v = _fa_inputs(torch, case, gen)

    def plain(q=q, k=k, v=v):
        return flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), window=window,
                                   prefix=prefix).transpose(1, 2)

    what = f"flash_attention {case}"
    route = ops.route(q, k, v)
    if route != _fa_want_route(case):
        raise AssertionError(f"{what}: route {route}, expected "
                             f"{_fa_want_route(case)}")
    keep = _fa_keep(torch, s, window, prefix)
    sdpa = _fa_sdpa(torch, q, k, v, keep)
    got = ops.flash_attention(q, k, v, window=window, prefix=prefix)
    err = _compare(torch, got, plain(), dt, what)
    held = (dict(vs_fp32_plain=_hold_fp32(
        torch, got, plain(q.float(), k.float(), v.float()),
        "flash_attention", what)) if fp32 else {})
    lib_err = float((sdpa().transpose(1, 2).float() - got.float())
                    .abs().max())
    del got
    kernel_ms = cuda_ms(torch, lambda: ops.flash_attention(
        q, k, v, window=window, prefix=prefix), iters)
    plain_ms = cuda_ms(torch, plain, 2, warmup=1)
    library_ms = cuda_ms(torch, sdpa, iters)
    bound = _fa_bound(ctx, case, int(keep.sum()))
    del bound["rates"]
    return dict(shape=dict(b=b, s=s, hq=hq, hkv=hkv, hd=hd, window=window,
                           prefix=prefix, dtype=dt),
                route=route, max_abs_err=err, ms=kernel_ms,
                plain_ms=plain_ms, library_ms=library_ms,
                library_max_abs_diff=lib_err, **bound,
                achieved_tflop_per_s=bound["flops"] / kernel_ms / 1e9,
                **held)


def _family_prefill(torch, cfg, params) -> dict:
    """`make_prefill_step(impl="kernel")` on 4 sequences of 2048
    positions (the prefix's included, from `synthetic_prefix`): one
    `flash_attention` launch per attention layer, last-position logits
    against impl="reference"."""
    import numpy as np
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.frontends import prefix_tokens, synthetic_prefix

    b, s = PREFILL_SHAPE
    p = prefix_tokens(cfg)
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (b, s - p)), device="cuda")}
    if p:
        batch["prefix_embeds"] = synthetic_prefix(cfg, b, seed=0,
                                                  device="cuda")
    step = make_prefill_step(cfg, impl="kernel")
    with torch.inference_mode():
        ops.flash_attention.launches = 0
        ops.flash_attention.launches_by_route.update(wgmma=0, cuda_core=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = step(params, batch)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = ops.flash_attention.launches
        routes = dict(ops.flash_attention.launches_by_route)
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(params, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        ref = make_prefill_step(cfg, impl="reference")(params, batch)
    ms = min(times) * 1e3
    return dict(batch=b, seq=s, prefix=p, flash_attention_launches=launches,
                flash_attention_routes=routes,
                first_call_s=first_s, ms_per_prefill=ms,
                ms_runs=[t * 1e3 for t in times],
                tokens_per_s=b * s / (ms / 1e3),
                finite=bool(torch.isfinite(logits).all()),
                shape=list(logits.shape), logits_rel_l2=_rel_l2(logits, ref),
                logits_max_abs_diff=float(
                    (logits.float() - ref.float()).abs().max()),
                logits_abs_max=float(ref.float().abs().max()),
                argmax_equal=int((logits.argmax(-1) == ref.argmax(-1)).sum()))


def _family_decode(torch, ctx, cfg, params, live_check=True) -> dict:
    """`_decode_run` with prompts of FAMILY_PROMPTS tokens and FAMILY_NEW
    greedy tokens; then, with ``live_check``, the kernel on the run's own
    caches (the first group) at the schedule's lengths against its plain
    version, and timed there."""
    run = _decode_run(torch, cfg, params, FAMILY_PROMPTS, FAMILY_NEW)
    with torch.inference_mode():
        live = (_decode_live_check(torch, ctx, cfg,
                                   run["state"].caches["kv"][0],
                                   run["lens_at"], row=False)
                if live_check else None)
    steps, step_s, rels = run["steps"], run["step_s"], run["rels"]
    gen_s = step_s[run["last"]:]
    return dict(slots=DECODE_SLOTS, max_seq=DECODE_MAX_SEQ,
                prompt_lengths=list(FAMILY_PROMPTS), new_tokens=FAMILY_NEW,
                steps=steps, decode_attention_launches=run["launches"],
                launches_off=run["launches_off"],
                ms_per_step=1e3 * sum(step_s) / steps,
                ms_per_step_generating=1e3 * sum(gen_s) / len(gen_s),
                tokens_per_s=DECODE_SLOTS * steps / sum(step_s),
                reference_ms_per_step=1e3 * sum(run["ref_s"]) / steps,
                logits_rel_l2_max=max(rels),
                logits_rel_l2_mean=sum(rels) / len(rels),
                greedy_same_share=run["agree"],
                kv_groups=[list(g["k"].shape)
                           for g in run["state"].caches["kv"]],
                decode_attention_main_path=live)


def _family_checks(cfg, pre, dec, tol, route) -> list:
    """The family's failed checks; ``route``: the one the rule gives the
    prefill's flash_attention inputs (bf16 at hd 64/128/256: wgmma)."""
    fails = []
    if pre["flash_attention_launches"] != cfg.num_layers:
        fails.append(f"flash_attention launched "
                     f"{pre['flash_attention_launches']} times in one "
                     f"prefill of {cfg.num_layers} attention layers")
    if pre["flash_attention_routes"][route] != cfg.num_layers:
        fails.append(f"flash_attention routes in one prefill "
                     f"{pre['flash_attention_routes']}, expected all "
                     f"{cfg.num_layers} on {route}")
    if not pre["finite"] or pre["shape"] != [PREFILL_SHAPE[0],
                                             cfg.vocab_size]:
        fails.append(f"prefill logits not finite of shape "
                     f"({PREFILL_SHAPE[0]}, {cfg.vocab_size})")
    if pre["logits_rel_l2"] > tol:
        fails.append(f"prefill logits: kernel vs reference relative L2 "
                     f"{pre['logits_rel_l2']} > {tol}")
    if dec["launches_off"] or dec["decode_attention_launches"] != \
            dec["steps"] * cfg.num_layers:
        fails.append(f"decode_attention launched "
                     f"{dec['decode_attention_launches']} times in "
                     f"{dec['steps']} steps of {cfg.num_layers} layers")
    if dec["logits_rel_l2_max"] > tol:
        fails.append(f"decode logits: kernel vs reference relative L2 up "
                     f"to {dec['logits_rel_l2_max']} > {tol}")
    return fails


def phase_llm_families(torch, ctx):
    """The moe, vlm and audio families and gemma3's mixed stack at full
    width and depth, bf16, random weights drawn on the card from seed 0,
    one model at a time (its weights released before the next):
    `_family_prefill`, `_fa_masked_row`, `_family_decode`, and for
    FAMILY_FP32 the prefill and decode again with the weights in fp32.
    Each model's readings print before the checks, which run for every
    model before the phase fails."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.models.frontends import prefix_tokens

    torch.use_deterministic_algorithms(False)
    torch.backends.cuda.matmul.allow_tf32 = False    # full fp32 GEMMs
    t_all = time.perf_counter()
    ctx["family_rows"] = []
    fails = []
    for arch in FAMILY_ARCHS:
        cfg = get_config(arch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = tf.init_params(cfg,
                                torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        pre = _family_prefill(torch, cfg, params)
        _timed(ctx, arch, "prefill", pre["batch"], pre["seq"] - pre["prefix"],
               pre["ms_per_prefill"])
        torch.cuda.empty_cache()
        wins = tf.layer_windows(cfg)
        fa = _fa_masked_row(
            torch, ctx, _fa_family_case(
                cfg, int(wins.max()),
                prefix_tokens(cfg) if cfg.family == "vlm" else 0),
            torch.Generator(device="cuda").manual_seed(11), 10)
        torch.cuda.empty_cache()
        dec = _family_decode(torch, ctx, cfg, params)
        fp32 = None
        if arch in FAMILY_FP32:
            p32 = _fp32_params(params)
            fp32 = dict(prefill=_family_prefill(torch, cfg, p32),
                        decode=_family_decode(torch, ctx, cfg, p32,
                                              live_check=False))
            del p32
        tol = FAMILY_LOGITS_REL_TOL[arch]
        emit(phase="llm_families", arch=cfg.name, family=cfg.family,
             layers=cfg.num_layers, params=cfg.param_count(),
             param_bytes=_param_bytes(params), init_s=init_s,
             windows=sorted({int(w) for w in wins}), rel_tol=tol,
             prefill=pre, flash_attention_shape=fa, decode=dec, fp32=fp32,
             peak_gb=torch.cuda.max_memory_allocated() / 1e9,
             nvidia_smi=ctx["smi"])
        del params
        torch.cuda.empty_cache()
        fails += [f"{cfg.name}: {f}" for f in _family_checks(
            cfg, pre, dec, tol["bf16"],
            _fa_want_route(_fa_family_case(cfg)))]
        if fp32 is not None:
            fails += [f"{cfg.name} fp32: {f}" for f in _family_checks(
                cfg, fp32["prefill"], fp32["decode"], tol["fp32"],
                "cuda_core")]
        ctx["launches"][f"flash_attention_{arch}"] = \
            pre["flash_attention_launches"]
        ctx["launches"][f"decode_attention_{arch}"] = \
            dec["decode_attention_launches"]
        live = dec["decode_attention_main_path"]
        ctx["family_rows"] += [
            ("flash_attention", dict(
                path=f"{cfg.name} prefill (4 x 2048, one launch a layer)",
                shape=fa["shape"], kernel_route=fa["route"],
                launches=pre["flash_attention_launches"],
                **{k: fa[k] for k in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by",
                                      "library_ms")})),
            ("decode_attention", dict(
                path=f"{cfg.name} decode ({dec['steps']} steps of 8 slots, "
                     "one launch a layer a step; timed on the run's first "
                     "cache group)",
                shape=live["shape"],
                launches=dec["decode_attention_launches"],
                max_abs_err=max(live["max_abs_diff"].values()),
                ms=live["kernel_ms"], plain_ms=live["plain_ms"],
                bound_ms=live["bound_ms"], bound_by=live["bound_by"],
                library_ms=live["library_ms"]))]
    if fails:
        raise AssertionError("; ".join(fails))
    emit(phase="llm_families", ok=True, archs=list(FAMILY_ARCHS),
         seconds=time.perf_counter() - t_all)


TRAIN_ARCHS = ("mamba2_370m", "granite_moe_1b")
TRAIN_SHAPE = (4, 2048)          # sequences x tokens a step
TRAIN_STEPS = 5
TRAIN_LR = 1e-3
FL_TRAIN_SHAPE = (2, 2048)       # per silo
#: `run_reduced_fl` on the card against the host (fp32 both, the same
#: initial weights): the CPU parity tests' 1e-4 against the reference
TRAIN_LOSS_RTOL = 1e-4


def _train_batch(torch, cfg, shape, seed, lead=()):
    import numpy as np
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, lead + (shape[0], shape[1] + 1))
    t = torch.as_tensor(toks, device="cuda")
    return {"tokens": t[..., :-1], "labels": t[..., 1:]}


def _train_steps(torch, arch) -> dict:
    """`make_train_step` at full width: bf16 parameters, fp32 AdamW state,
    remat, ce_block 256, TRAIN_STEPS steps on one repeated batch; the
    first step's loss against `loss_fn` on the same batch, a profile of
    one more step."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw

    cfg = get_config(arch)
    params = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    batch = _train_batch(torch, cfg, TRAIN_SHAPE, seed=5)
    with torch.no_grad():
        direct, parts = tf.loss_fn(params, cfg, batch, impl="chunked",
                                   ce_block=256)
        direct = float(direct)
    opt = adamw(TRAIN_LR)
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, params, state = step(params, state, batch)
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    ms = 1e3 * sum(times[1:]) / (TRAIN_STEPS - 1)
    holder = {"p": params, "s": state}

    def one():
        _, holder["p"], holder["s"] = step(holder["p"], holder["s"], batch)

    profile = profile_window(torch, one, 1, ms)
    tokens = TRAIN_SHAPE[0] * TRAIN_SHAPE[1]
    out = dict(arch=cfg.name, params=cfg.param_count(), batch=TRAIN_SHAPE[0],
               seq=TRAIN_SHAPE[1], lr=TRAIN_LR, remat=True, ce_block=256,
               losses=losses, loss_fn=direct, aux=float(parts["aux"]),
               first_vs_loss_fn_rel=abs(losses[0] - direct) / abs(direct),
               ms_per_step=ms, ms_runs=[t * 1e3 for t in times],
               tokens_per_s=tokens / (ms / 1e3),
               max_memory_allocated=peak,
               max_memory_allocated_gb=peak / 1e9, profile=profile)
    del params, state, holder
    torch.cuda.empty_cache()
    return out


def _fl_train_round(torch) -> dict:
    """`make_fl_train_step` on 2 silos of mamba2-370m at full width (batch
    2 x 2048 a silo, deterministic algorithms on): a `gossip=False` round
    and a `gossip=True` round from the same state; each silo's gossiped
    parameters must equal `torch.einsum` of the consensus and the local
    updates, leaf by leaf, bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import tree_leaves, tree_map
    from repro_torch.launch.steps import make_fl_train_step, ring_consensus
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw

    cfg = get_config("mamba2_370m")
    n = 2
    params = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    params = tree_map(lambda x: torch.stack([x] * n), params)
    opt = adamw(TRAIN_LR)
    state = opt.init(params)
    batch = _train_batch(torch, cfg, FL_TRAIN_SHAPE, seed=6, lead=(n,))
    _deterministic(torch)
    times = {}
    out = {}
    for gossip in (False, True):
        step = make_fl_train_step(cfg, n, opt, gossip=gossip)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, p, _ = step(params, state, batch)
        torch.cuda.synchronize()
        times[gossip] = time.perf_counter() - t0
        out[gossip] = (float(loss), p)
    torch.use_deterministic_algorithms(False)
    a = torch.as_tensor(ring_consensus(n), device="cuda")
    local, mixed = out[False][1], out[True][1]
    want = tree_map(lambda w: torch.einsum("ij,j...->i...", a, w.float())
                    .to(w.dtype), local)
    pairs = list(zip(tree_leaves(mixed), tree_leaves(want)))
    unequal = sum(not torch.equal(g, w) for g, w in pairs)
    spread = max(float((g[0].float() - g[1].float()).abs().max())
                 for g, _ in pairs)
    res = dict(silos=n, batch=FL_TRAIN_SHAPE, losses=[out[False][0],
                                                      out[True][0]],
               round_s={"local": times[False], "gossip": times[True]},
               leaves=len(pairs), leaves_unequal=unequal,
               gossip_silo_spread=spread)
    del params, state, out, local, mixed, want, pairs
    torch.cuda.empty_cache()
    if unequal or spread != 0.0 or _not_finite(res["losses"]):
        raise AssertionError(f"fl_train_step gossip round: {res}")
    return res


def _not_finite(losses) -> bool:
    return not all(math.isfinite(x) for x in losses)


def _reduced_fl(torch, ctx) -> dict:
    """`run_reduced_fl` at the CLI's defaults (mamba2-370m reduced, 4 gaia
    silos, the multigraph, 30 rounds) on the card, the launch count
    zeroed just before and read just after: one launch of the fused
    kernel a round for all leaves; then the same config with
    device="cpu", whose simulated fields must be equal exactly (host
    numpy). A generator on the card draws other initial weights than one
    on the host, so the card runs once more from the host run's initial
    weights: its losses must lie within TRAIN_LOSS_RTOL of the host
    run's. (The kernel over the run's leaves is timed in phase
    edge_aggregate.)"""
    from repro_torch.configs import get_config, reduce
    from repro_torch.kernels.gossip_combine import ops
    from repro_torch.launch import train
    from repro_torch.launch.mesh import tree_leaves, tree_map

    cfg = train.TrainConfig()
    ops.edge_aggregate.launches = 0
    t0 = time.perf_counter()
    card = train.run_reduced_fl(cfg)
    card_s = time.perf_counter() - t0
    launches = ops.edge_aggregate.launches
    t0 = time.perf_counter()
    cpu = train.run_reduced_fl(cfg, device="cpu")
    cpu_s = time.perf_counter() - t0
    draw = train.initial_params
    train.initial_params = lambda m, seed, dev: tree_map(
        lambda x: x.to(dev), draw(m, seed, "cpu"))
    try:
        same = train.run_reduced_fl(cfg)
    finally:
        train.initial_params = draw
    same_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(same["losses"], cpu["losses"]))
    leaves = len(tree_leaves(train.initial_params(
        reduce(get_config(cfg.arch)), 0, "cpu")))
    res = dict(rounds=cfg.rounds, silos=cfg.silos, leaves=leaves,
               launches=launches, card_s=card_s, cpu_s=cpu_s,
               losses_card=card["losses"],
               loss_max_rel_diff_same_start_vs_cpu=same_rel,
               loss_rtol=TRAIN_LOSS_RTOL,
               sim={k: card[k] for k in ("sim_mean_cycle_ms",
                                         "sim_total_time_s")})
    if launches != cfg.rounds:
        raise AssertionError(f"run_reduced_fl: edge_aggregate launched "
                             f"{launches} times in {cfg.rounds} rounds")
    if _not_finite(card["losses"]):
        raise AssertionError(f"run_reduced_fl: losses {card['losses']}")
    if same_rel > TRAIN_LOSS_RTOL:
        raise AssertionError(f"run_reduced_fl from the host's initial "
                             f"weights: losses {same_rel} relative from the "
                             f"host run's (limit {TRAIN_LOSS_RTOL})")
    for k in ("sim_mean_cycle_ms", "sim_total_time_s"):
        if card[k] != cpu[k]:
            raise AssertionError(f"run_reduced_fl: {k} {card[k]} on the "
                                 f"card, {cpu[k]} on the CPU")
    ctx["launches"]["edge_aggregate_train"] = launches
    return res


def _serving_cli_trains(torch, tmp: Path) -> dict:
    """`python -m repro_torch.serving --ckpt-dir DIR --bench B`: trains
    (the reference's defaults: mamba2-370m reduced, 6 gaia silos, 6
    rounds, t 2) then serves, on the card; exit 0, and `python -m
    repro_torch.obs validate --bench B` accepts its rows."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    bench = tmp / "BENCH_torch_serving.json"
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.serving",
                        "--ckpt-dir", str(tmp / "trained"), "--bench",
                        str(bench)], env=env, cwd=tmp, capture_output=True,
                       text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"serving CLI (train, then serve) exit "
                             f"{r.returncode}: {r.stderr[-2000:]}")
    out = json.loads(r.stdout)
    check = subprocess.run([sys.executable, "-m", "repro_torch.obs",
                            "validate", "--bench", str(bench)], env=env,
                           cwd=tmp, capture_output=True, text=True,
                           timeout=300)
    if check.returncode != 0:
        raise AssertionError(f"validate --bench exit {check.returncode}: "
                             f"{check.stdout[-1000:]}{check.stderr[-1000:]}")
    return dict(exit=0, seconds=cli_s, train=out["train"],
                ckpt_step=out["ckpt_step"], regions=len(out["regions"]),
                serve=out["serve"], validate_exit=0)


def phase_llm_train(torch, ctx):
    """LLM training on the card: `_train_steps` for TRAIN_ARCHS (losses
    finite and falling from step 1 to the last, the first within 1e-3
    relative of `loss_fn`), `_fl_train_round`, `_reduced_fl` and
    `_serving_cli_trains`."""
    import tempfile

    torch.use_deterministic_algorithms(False)
    t0 = time.perf_counter()
    steps = {arch: _train_steps(torch, arch) for arch in TRAIN_ARCHS}
    for arch, r in steps.items():
        _timed(ctx, arch, "train", r["batch"], r["seq"], r["ms_per_step"],
               peak_bytes=r["max_memory_allocated"])
    emit(phase="llm_train", part="train_step", steps=steps,
         nvidia_smi=ctx["smi"])
    for arch, r in steps.items():
        ls = r["losses"]
        if _not_finite(ls) or not ls[-1] < ls[0] or \
                r["first_vs_loss_fn_rel"] > 1e-3:
            raise AssertionError(f"train step {arch}: losses {ls}, loss_fn "
                                 f"{r['loss_fn']}")
    fl = _fl_train_round(torch)
    reduced = _reduced_fl(torch, ctx)
    with tempfile.TemporaryDirectory() as tmp:
        cli = _serving_cli_trains(torch, Path(tmp))
    emit(phase="llm_train", ok=True, seconds=time.perf_counter() - t0,
         fl_train_step=fl, run_reduced_fl=reduced, serving_cli=cli,
         nvidia_smi=ctx["smi"])


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
    own; `window_s`, the seconds the whole window took, the profiler's
    own processing included."""
    torch.cuda.synchronize()
    t_window = time.perf_counter()
    with profiled(torch) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / iters
    kern = sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in device_averages(prof)
                   if ev.self_device_time_total > 0), reverse=True)
    host = sorted(((ev.self_cpu_time_total, ev.key, ev.count)
                   for ev in host_averages(prof)
                   if ev.self_cpu_time_total > 0), reverse=True)
    busy = sum(x[0] for x in kern) / 1e3 / iters
    return dict(
        calls=iters, device_busy_ms=busy, profiled_wall_ms=wall,
        window_s=time.perf_counter() - t_window,
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


def profiler_bench(torch, seconds: float) -> int:
    """``python3 chip_smoke.py --profiler-bench SECONDS`` profiles 20
    launches of a short kernel about every 45 s for SECONDS, in a bare
    window and in one padded as `profiled` pads it, with 25 s of 8192 x
    8192 matrix products between samples; one JSON line a sample: the
    kernel records each window saw, out of 20 (PROFILE_PAD_S's
    evidence)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(256, 256, device="cuda")
    work = torch.randn(8192, 8192, device="cuda")

    def records(window) -> int:
        with window as prof:
            for _ in range(20):
                torch.mul(x, 2.0)
            torch.cuda.synchronize()
        return sum(ev.device_type == DeviceType.CUDA for ev in prof.events())

    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        bare = records(profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]))
        emit(t_s=time.perf_counter() - t0, bare=bare,
             padded=records(profiled(torch)), of=20)
        end = time.perf_counter() + 25
        while time.perf_counter() < end:
            work @ work
        torch.cuda.synchronize()
    print(nvidia_smi_line(), flush=True)
    return 0


BENCHES = {"--decode-bench": decode_bench, "--ssd-bench": ssd_bench,
           "--cycle-bench": cycle_bench}


def main() -> int:
    if len(sys.argv) == 3 and (sys.argv[1] in BENCHES
                               or sys.argv[1] == "--profiler-bench"):
        import torch
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device", file=sys.stderr)
            return 1
        if sys.argv[1] == "--profiler-bench":
            return profiler_bench(torch, float(sys.argv[2]))
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
              phase_llm_prefill, phase_llm_decode, phase_sharded,
              phase_ssd_scan,
              phase_ssm_prefill, phase_ssm_decode, phase_hybrid_prefill,
              phase_hybrid_decode, phase_serving, phase_llm_families,
              phase_llm_train, phase_gossip_combine,
              phase_ring_gossip,
              phase_run_fl_surface, phase_fl_mesh, phase_launch_analysis,
              phase_sharded_host, phase_run_fl_models,
              phase_topologies,
              phase_design_loop, phase_design_search]
    walls = {}
    try:
        for phase in phases:
            name = phase.__name__[len("phase_"):]
            t0 = time.perf_counter()
            try:
                phase(torch, ctx)
            except Exception as exc:
                emit(phase=name, ok=False,
                     error=f"{type(exc).__name__}: {exc}")
                traceback.print_exc()
                return 1
            walls[name] = time.perf_counter() - t0
            if name == HOST_WORK_AFTER:
                start_host_work(ctx)
    finally:
        waited = stop_host_work(ctx)
    emit(phase="timeline", ok=True, phase_wall_s=walls,
         total_s=time.perf_counter() - T_START,
         host_work=dict(after=HOST_WORK_AFTER, waited_s=waited))
    ea = "src/repro/kernels/gossip_combine/kernel.py:114"
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    rows = ctx["edge_aggregate_rows"]
    pali = ctx["flash_attention_paligemma"]

    def ea_row(launches, timed, **what):
        return dict(_kernel_row(ctx, "edge_aggregate", ea), **what,
                    launches=ctx["launches"][launches],
                    **{k: timed[k] for k in keys})

    print(json.dumps({"kernels": [
        _kernel_row(ctx, "edge_aggregate", ea),
        ea_row("edge_aggregate_wan64",
               ctx["edge_aggregate_shapes"]["femnist_wan64"],
               shape="wan64: N=64, 2E=128, T=1,280,478"),
        ea_row("edge_aggregate_design_loop", ctx["edge_aggregate"],
               path="design_loop: evaluate_frontier, 3 candidates x "
                    f"{DESIGN_ROUNDS} rounds at the main shape"),
        ea_row("edge_aggregate_controller", ctx["edge_aggregate"],
               path="controller: 4 runs x 48 rounds at the main shape"),
        ea_row("edge_aggregate_legacy", rows["femnist_cnn_leaves"],
               path=f"legacy run_fl: one launch a round for the CNN's 6 "
                    f"leaves, {ROUNDS} rounds; timed on the 6 leaves"),
        ea_row("edge_aggregate_mesh", rows["mesh_shards"],
               path=f"mesh: run_fl on {MESH_ROW_SHARDS} stacked shards, one "
                    f"launch a round for all shards, {ROUNDS} rounds; timed "
                    "on the shards' padded blocks at the main width"),
        ea_row("edge_aggregate_train", rows["mamba2_leaves"],
               path="run_reduced_fl at the CLI's defaults: one launch a "
                    "round for all 12 leaves; timed on the 12 leaves"),
        _kernel_row(ctx, "gossip_combine",
                    "src/repro/kernels/gossip_combine/kernel.py:46"),
        _kernel_row(ctx, "flash_attention",
                    "src/repro/kernels/flash_attention/kernel.py:104"),
        dict(_kernel_row(ctx, "flash_attention",
                         "src/repro/kernels/flash_attention/kernel.py:104"),
             path="paligemma-3b prefill (one launch a layer); timed at "
                  "FA_PALIGEMMA in phase flash_attention",
             shape=pali["shape"], kernel_route=pali["route"],
             launches=ctx["launches"]["flash_attention_paligemma_3b"],
             **{k: pali[k] for k in keys}),
        dict(_kernel_row(ctx, "flash_attention",
                         "src/repro/kernels/flash_attention/kernel.py:104"),
             path="sharded: yi-9b prefill on a one-rank (1, 1) DTensor "
                  "mesh, the kernel on the rank's head shard; timed at "
                  "FA_MAIN in phase flash_attention",
             kernel_route="wgmma",
             launches=ctx["launches"]["flash_attention_sharded"]),
        _kernel_row(ctx, "decode_attention",
                    "src/repro/kernels/decode_attention/kernel.py:75"),
        dict(_kernel_row(ctx, "decode_attention",
                         "src/repro/kernels/decode_attention/kernel.py:75"),
             path="sharded: yi-9b decode on a one-rank (1, 1) DTensor mesh, "
                  "the caches DTensors; timed at the yi-9b decode shape in "
                  "phase llm_decode",
             launches=ctx["launches"]["decode_attention_sharded"]),
        *[dict(_kernel_row(ctx, "decode_attention",
                           "src/repro/kernels/decode_attention/kernel.py:75"),
               **row) for row in ctx["serving_rows"]],
        *[dict(_kernel_row(ctx, name, FAMILY_REPLACES[name]), **row)
          for name, row in ctx["family_rows"]],
        _kernel_row(ctx, "ssd_scan",
                    "src/repro/kernels/ssd_scan/kernel.py:71")]}))
    print(ctx["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": ctx["kind"], "count": ctx["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
