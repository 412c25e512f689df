"""Roofline analysis: three terms per (arch x shape x mesh) (counterpart
of `repro.launch.roofline`).

    compute_s    = FLOPs / (chips * bf16 peak)
    memory_s     = HBM bytes / (chips * HBM rate)
    collective_s = collective bytes / link rate

The FLOPs and bytes are the reference's analytic model, term for term:
exact matmul formulas per architecture family (attention context
averaged over causal and windowed masks, active-only MoE FLOPs, SSD
dual-form terms) and a coarse, documented HBM byte model. The dry run
(`launch/dryrun.py`) measures FLOPs with `FlopCounterMode` beside them.

Two sets of rates: the reference's v5e constants (`PEAK_FLOPS`,
`HBM_BW`, `LINK_BW`) price its "single" and "multi" meshes, so that a
reference report gives the reference's row; the H100 SXM data sheet's
(`H100_*`) price the port's meshes: "h100" (one card), "h100_fl2" (the
two-silo FL round on one card) and the sharded program's "h100x256" and
"h100x512" (the reference's (16, 16) and (2, 16, 16) meshes of H100s,
priced per card, its collective bytes over `H100_NVLINK_BW`: the rate
of one card's NVLink, an upper bound for a mesh that spans nodes, whose
cross-node links are slower). A report's ``mesh_shape`` (a ``--debug``
dry run's (2, 2) or (2, 2, 2)) sets its number of chips. `CARD_RATES`
is the table of cards that `chip_smoke.py` reads for its bounds.

MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE); the ratio
MODEL_FLOPS / FLOPs_total exposes remat, attention and padding
overheads.

    python -m repro_torch.launch.roofline [DRYRUN_DIR]

prints the markdown table of the dry-run reports in DRYRUN_DIR
(default experiments/dryrun_torch).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np

from repro_torch.configs import get_config
from repro_torch.launch.specs import (SHAPES, InputShape, meta_leaves,
                                      params_shape)
from repro_torch.models.config import ModelConfig
from repro_torch.models.frontends import prefix_tokens
from repro_torch.models.transformer import layer_windows, num_shared_attn_apps

PEAK_FLOPS = 197e12      # bf16 per chip (v5e)
HBM_BW = 819e9           # bytes/s per chip
LINK_BW = 50e9           # bytes/s per ICI link

# One NVIDIA H100 SXM (data sheet, dense, at its 700 W limit).
H100_BF16_FLOPS = 989e12   # bf16 tensor cores
H100_FP32_FLOPS = 67e12    # fp32 outside the tensor cores
H100_HBM_BW = 3.35e12      # bytes/s
H100_NVLINK_BW = 900e9     # bytes/s per GPU, all links together

CHIPS = {"single": 256, "multi": 512, "h100": 1, "h100_fl2": 1,
         "h100x256": 256, "h100x512": 512}
#: meshes priced with the H100's rates; the others with the v5e's
H100_MESHES = ("h100", "h100_fl2", "h100x256", "h100x512")

#: Data-sheet rates of the cards the port may meet, matched by substring
#: of `torch.cuda.get_device_name` in this order: (name, HBM bytes/s,
#: fp32 flop/s, dense bf16 tensor flop/s).
CARD_RATES = (("H200", 4.8e12, 67e12, 989e12),
              ("H100 NVL", 3.9e12, 60e12, 835e12),
              ("H100 PCIe", 2.0e12, 51e12, 756e12),
              ("H100", H100_HBM_BW, H100_FP32_FLOPS, H100_BF16_FLOPS))


def card_rates(name: str) -> tuple[float, float, str]:
    """(HBM bytes/s, fp32 flop/s, name of the row used) of a card."""
    for key, bw, flops, _ in CARD_RATES:
        if key in name:
            return bw, flops, key
    return H100_HBM_BW, H100_FP32_FLOPS, "H100 SXM (assumed)"


def bf16_peak(name: str) -> float:
    """Dense bf16 tensor-core flop/s of a card."""
    for key, _, _, bf16 in CARD_RATES:
        if key in name:
            return bf16
    return H100_BF16_FLOPS


def mesh_rates(mesh: str) -> tuple[float, float, float]:
    """(peak flop/s, HBM bytes/s, link bytes/s) per chip of a mesh."""
    if mesh in H100_MESHES:
        return H100_BF16_FLOPS, H100_HBM_BW, H100_NVLINK_BW
    return PEAK_FLOPS, HBM_BW, LINK_BW


# ---------------------------------------------------------------------------
# analytic FLOPs
# ---------------------------------------------------------------------------


def _avg_ctx(seq: int, window: int) -> float:
    """Mean attended context per query under a causal (+window) mask."""
    if window and window < seq:
        # first `window` positions grow linearly, the rest see `window`
        ramp = window * (window + 1) / 2
        return (ramp + (seq - window) * window) / seq
    return (seq + 1) / 2


def _attn_flops(cfg: ModelConfig, tokens: float, seq: int,
                window: int) -> float:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    proj = 2 * tokens * d * (qd + 2 * kvd) + 2 * tokens * qd * d
    ctx = _avg_ctx(seq, window)
    attn = 4 * tokens * ctx * qd  # scores + AV
    return proj + attn


def _mlp_flops(cfg: ModelConfig, tokens: float) -> float:
    return 6 * tokens * cfg.d_model * cfg.d_ff


def _moe_flops(cfg: ModelConfig, tokens: float) -> float:
    route = 2 * tokens * cfg.d_model * cfg.num_experts
    act = 6 * tokens * cfg.experts_per_token * cfg.d_model * cfg.expert_d_ff
    return route + act


def _mamba_flops(cfg: ModelConfig, tokens: float) -> float:
    d, di, ns, nh, hp = (cfg.d_model, cfg.ssm_inner, cfg.ssm_state,
                         cfg.ssm_heads, cfg.ssm_head_dim)
    q = cfg.ssm_chunk
    proj = 2 * tokens * d * (2 * di + 2 * ns + nh)
    conv = 2 * tokens * cfg.ssm_conv * (di + 2 * ns)
    # SSD dual form, per token: scores 2*Q*ns ; y_diag 2*Q*nh*hp ;
    # y_inter + state inject ~ 4*ns*nh*hp
    ssd = tokens * (2 * q * ns + 2 * q * nh * hp + 4 * ns * nh * hp)
    out = 2 * tokens * di * d
    return proj + conv + ssd + out


def forward_flops(cfg: ModelConfig, shape: InputShape, *,
                  include_unembed: bool = True,
                  last_only: bool = False) -> float:
    b, s = shape.global_batch, shape.seq_len
    p = prefix_tokens(cfg)
    s_eff = s + p
    tokens = float(b) * s_eff
    wins = layer_windows(cfg)
    total = 0.0
    if cfg.family in ("dense", "vlm", "audio"):
        for w in wins:
            total += _attn_flops(cfg, tokens, s_eff, int(w))
            total += _mlp_flops(cfg, tokens)
    elif cfg.family == "moe":
        for w in wins:
            total += _attn_flops(cfg, tokens, s_eff, int(w))
            total += _moe_flops(cfg, tokens)
    elif cfg.family == "ssm":
        total += cfg.num_layers * _mamba_flops(cfg, tokens)
    elif cfg.family == "hybrid":
        total += cfg.num_layers * _mamba_flops(cfg, tokens)
        apps = num_shared_attn_apps(cfg)
        total += apps * (_attn_flops(cfg, tokens, s_eff, cfg.sliding_window)
                         + _mlp_flops(cfg, tokens))
    if include_unembed:
        un_tokens = float(b) if last_only else tokens
        total += 2 * un_tokens * cfg.d_model * cfg.vocab_size
    return total


def train_flops(cfg: ModelConfig, shape: InputShape, *,
                remat: bool = True) -> float:
    """fwd (1x) + bwd (2x) + remat recompute (1x) = 4x forward matmuls."""
    f = forward_flops(cfg, shape)
    return f * (4.0 if remat else 3.0)


def decode_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """One decode step: B tokens, attention against the live context."""
    b, s = shape.global_batch, shape.seq_len
    tokens = float(b)
    wins = layer_windows(cfg)
    total = 0.0

    def attn_dec(window):
        ctx = min(window, s) if window else s
        d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
        return (2 * tokens * d * (qd + 2 * kvd) + 2 * tokens * qd * d
                + 4 * tokens * ctx * qd)

    if cfg.family in ("dense", "vlm", "audio"):
        for w in wins:
            total += attn_dec(int(w)) + _mlp_flops(cfg, tokens)
    elif cfg.family == "moe":
        for w in wins:
            total += attn_dec(int(w)) + _moe_flops(cfg, tokens)
    elif cfg.family == "ssm":
        # recurrent step: 2*ns*nh*hp state update + projections
        d, di, ns, nh, hp = (cfg.d_model, cfg.ssm_inner, cfg.ssm_state,
                             cfg.ssm_heads, cfg.ssm_head_dim)
        per = (2 * tokens * d * (2 * di + 2 * ns + nh)
               + 4 * tokens * ns * nh * hp + 2 * tokens * di * d)
        total += cfg.num_layers * per
    elif cfg.family == "hybrid":
        d, di, ns, nh, hp = (cfg.d_model, cfg.ssm_inner, cfg.ssm_state,
                             cfg.ssm_heads, cfg.ssm_head_dim)
        per = (2 * tokens * d * (2 * di + 2 * ns + nh)
               + 4 * tokens * ns * nh * hp + 2 * tokens * di * d)
        total += cfg.num_layers * per
        total += num_shared_attn_apps(cfg) * (
            attn_dec(cfg.sliding_window) + _mlp_flops(cfg, tokens))
    total += 2 * tokens * cfg.d_model * cfg.vocab_size  # unembed
    return total


def analytic_flops(cfg: ModelConfig, shape: InputShape) -> float:
    if shape.mode == "train":
        return train_flops(cfg, shape)
    if shape.mode == "prefill":
        return forward_flops(cfg, shape, last_only=True)
    return decode_flops(cfg, shape)


# ---------------------------------------------------------------------------
# analytic HBM bytes (coarse, documented model)
# ---------------------------------------------------------------------------


def _dtype_bytes(cfg: ModelConfig) -> int:
    return 2 if cfg.dtype == "bfloat16" else 4


def analytic_bytes(cfg: ModelConfig, shape: InputShape) -> float:
    n = cfg.param_count()
    na = cfg.active_param_count()
    wb = _dtype_bytes(cfg)
    b, s = shape.global_batch, shape.seq_len
    tokens = float(b) * (s + prefix_tokens(cfg))
    if shape.mode == "train":
        # weights: fwd + bwd + remat reads (3x), grad writes, AdamW
        # state read+write f32 (m, v) + param update
        weights = n * wb * 3 + n * wb + n * (8 + 8 + 4 + 4)
        # activations: ~6 tensor r/w per layer boundary
        acts = cfg.num_layers * tokens * cfg.d_model * wb * 6
        return weights + acts
    if shape.mode == "prefill":
        weights = n * wb
        acts = cfg.num_layers * tokens * cfg.d_model * wb * 4
        kv = cfg.num_layers * tokens * 2 * cfg.kv_dim * wb  # cache writes
        return weights + acts + kv
    # decode: stream active weights once + read the KV/ssm state
    weights = na * wb
    kv = 0.0
    if cfg.uses_attention and cfg.num_heads:
        wins = layer_windows(cfg)
        for w in wins if cfg.family != "hybrid" else []:
            ctx = min(int(w), s) if w else s
            kv += float(b) * ctx * 2 * cfg.kv_dim * wb
        if cfg.family == "hybrid":
            ctx = min(cfg.sliding_window, s) if cfg.sliding_window else s
            kv += num_shared_attn_apps(cfg) * float(b) * ctx * 2 * cfg.kv_dim * wb
    if cfg.uses_ssm:
        kv += (cfg.num_layers * float(b) * cfg.ssm_heads * cfg.ssm_head_dim
               * cfg.ssm_state * 4 * 2)  # read + write f32 state
    return weights + kv


def bound_ms(cfg: ModelConfig, shape: InputShape, *,
             card: str = "H100") -> dict:
    """The analytic step's least time on a card (`CARD_RATES`): the larger
    of its FLOPs over the bf16 peak and its bytes over the HBM rate."""
    fl, by = analytic_flops(cfg, shape), analytic_bytes(cfg, shape)
    bw, _, row = card_rates(card)
    ops_ms = fl / bf16_peak(card) * 1e3
    bytes_ms = by / bw * 1e3
    return dict(flops=fl, bytes=by, rates=row, compute_ms=ops_ms,
                memory_ms=bytes_ms, bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


# ---------------------------------------------------------------------------
# FL mesh memory / collective model (DESIGN.md §16)
# ---------------------------------------------------------------------------

FL_HBM_PER_DEVICE = 80e9  # one accelerator per silo shard (80 GB class)


def fl_mesh_report(arch: str, *, network: str = "gaia", num_shards: int = 8,
                   rank: int = 8, t: int = 5,
                   hbm_per_device: float = FL_HBM_PER_DEVICE) -> dict:
    """Dry-run the mesh-sharded FL runtime's memory/collective budget.

    Lays the `network`'s multigraph CSR plan over `num_shards` silo
    shards with the EXACT layout fl/mesh.py builds (block rows,
    dst-sharded padded edges, halo exchange derived from the CSR), then
    prices per-device HBM for the two per-silo state models:

      * full:  (N, T_full) rows + (2E, T_full) edge buffers, f32 —
        w + momentum + the shard's buffer rows;
      * lora:  frozen base replicated ONCE per device in the model's
        own dtype, plus (N, T_lora) low-rank deltas (fl/lora.py) and
        (2E, T_lora) buffers.

    Collective bytes per round compare the all_gather baseline (every
    shard receives all other shards' rows) against the halo exchange
    (only boundary-crossing CSR source rows move), both for ONE device;
    `fl_mesh_fabric_bytes` converts them to the mesh runtime's own
    count over all shards. No devices are needed: this is the plan-build
    arithmetic, so it prices the full-size configs on any host.
    """
    from repro_torch.core import timing
    from repro_torch.core.delay import FEMNIST
    from repro_torch.fl import dpasgd, lora
    from repro_torch.fl.mesh import _build_halo, block_layout
    from repro_torch.kernels.gossip_combine.ops import csr_sort
    from repro_torch.networks import get_network

    cfg = get_config(arch)
    template = params_shape(cfg)
    t_full = int(sum(int(np.prod(x.shape)) if x.shape else 1
                     for x in meta_leaves(template)))
    t_lora = lora.lora_size(template, rank)

    net = get_network(network)
    n = net.num_silos
    plan, _, _ = dpasgd.multigraph_plan(
        net, timing.multigraph_timing_plan(net, FEMNIST, t=t))
    order, _ = csr_sort(plan.dst, n)
    dst_sorted = plan.dst[order].astype(np.int64)
    src_sorted = plan.src[order].astype(np.int64)

    d = num_shards
    per = -(-n // d)
    counts, _, _, src_global = block_layout(dst_sorted, src_sorted, d, per)
    e_per = int(src_global.shape[1])
    halo_rows = _build_halo(counts, src_global, d, per).halo_rows

    base_bytes = t_full * _dtype_bytes(cfg)
    # persistent per-device state: w + momentum rows, this shard's edge
    # buffer rows; flat training state is f32 (DESIGN.md §9)
    full_state = (2 * per + e_per) * t_full * 4
    lora_state = (2 * per + e_per) * t_lora * 4

    def _coll(t_width: int) -> dict:
        return {"all_gather": (d - 1) * per * t_width * 4,
                "halo": halo_rows * t_width * 4}

    full_total = full_state + _coll(t_full)["halo"]
    lora_total = base_bytes + lora_state + _coll(t_lora)["halo"]
    return {
        "arch": arch, "network": network, "num_shards": d, "rank": rank,
        "num_silos": n, "per_shard_rows": per, "edges_per_shard": e_per,
        "halo_rows": halo_rows, "t_full": t_full, "t_lora": t_lora,
        "hbm_per_device": hbm_per_device,
        "full": {"state_bytes": full_state,
                 "collective_bytes_per_round": _coll(t_full),
                 "total_bytes": full_total,
                 "fits": full_total <= hbm_per_device},
        "lora": {"base_bytes": base_bytes, "state_bytes": lora_state,
                 "collective_bytes_per_round": _coll(t_lora),
                 "total_bytes": lora_total,
                 "fits": lora_total <= hbm_per_device},
    }


def fl_mesh_fabric_bytes(report: dict, backend: str,
                         t: int | None = None) -> int:
    """`fl_mesh_report`'s layout in the mesh runtime's own count: the
    bytes a round moves across the fabric summed over ALL shards, own
    rows included (`fl/gossip.fabric_rows_per_round` times the flat row,
    the `fabric_bytes` metric). halo: D * halo_rows rows; all_gather:
    D * rows_padded = D * D * per rows. ``t`` is the flat row's width
    (the report's T_full by default). The report prices one device
    instead (halo_rows, and (D - 1) * per for all_gather); neither
    definition changes."""
    from repro_torch.fl.gossip import fabric_rows_per_round
    d = report["num_shards"]
    rows = fabric_rows_per_round(
        backend, halo_rows=report["halo_rows"], num_shards=d,
        rows_padded=d * report["per_shard_rows"])
    return rows * (report["t_full"] if t is None else t) * 4


def fl_mesh_table(archs, **kw) -> str:
    rows = [fl_mesh_report(a, **kw) for a in archs]
    out = ["| arch | T_full | T_lora | full GB/dev | fits | "
           "lora GB/dev | fits | halo/AG bytes |",
           "|" + "---|" * 8]
    for r in rows:
        ag = r["lora"]["collective_bytes_per_round"]["all_gather"]
        halo = r["lora"]["collective_bytes_per_round"]["halo"]
        out.append(
            f"| {r['arch']} | {r['t_full']:.3g} | {r['t_lora']:.3g} "
            f"| {r['full']['total_bytes'] / 1e9:.1f} "
            f"| {'yes' if r['full']['fits'] else 'NO'} "
            f"| {r['lora']['total_bytes'] / 1e9:.1f} "
            f"| {'yes' if r['lora']['fits'] else 'NO'} "
            f"| {halo / max(ag, 1):.2f}x |")
    return "\n".join(out)


# ---------------------------------------------------------------------------
# report assembly
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    status: str
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    dominant: str = ""
    model_flops: float = 0.0
    flops_total: float = 0.0
    flops_measured_raw: float = 0.0
    useful_ratio: float = 0.0
    note: str = ""

    def as_dict(self):
        return dataclasses.asdict(self)


def model_flops_6nd(cfg: ModelConfig, shape: InputShape) -> float:
    tokens = float(shape.global_batch) * (
        shape.seq_len if shape.mode != "decode" else 1)
    n = cfg.active_param_count()
    mult = 6 if shape.mode == "train" else 2
    return mult * n * tokens


def roofline_row(report: dict) -> RooflineRow:
    arch, shape_name = report["arch"], report["shape"]
    mesh = report["mesh"]
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    row = RooflineRow(arch=arch, shape=shape_name, mesh=mesh,
                      status=report["status"])
    if report["status"] != "ok":
        row.note = report.get("reason", report.get("error", ""))[:200]
        return row
    chips = (int(np.prod(report["mesh_shape"])) if "mesh_shape" in report
             else CHIPS[mesh])
    peak, hbm, link = mesh_rates(mesh)
    fl = analytic_flops(cfg, shape)
    by = analytic_bytes(cfg, shape)
    row.flops_total = fl
    row.flops_measured_raw = report["cost"]["flops"] * chips
    row.compute_s = fl / (chips * peak)
    row.memory_s = by / (chips * hbm)
    row.collective_s = report["collectives"]["total_bytes"] / link
    terms = {"compute": row.compute_s, "memory": row.memory_s,
             "collective": row.collective_s}
    row.dominant = max(terms, key=terms.get)
    row.model_flops = model_flops_6nd(cfg, shape)
    row.useful_ratio = row.model_flops / max(fl, 1.0)
    return row


def load_reports(dryrun_dir: str | pathlib.Path) -> list[dict]:
    d = pathlib.Path(dryrun_dir)
    return [json.loads(p.read_text()) for p in sorted(d.glob("*.json"))]


def table(dryrun_dir: str | pathlib.Path) -> list[RooflineRow]:
    return [roofline_row(r) for r in load_reports(dryrun_dir)]


def markdown_table(rows: list[RooflineRow]) -> str:
    hdr = ("| arch | shape | mesh | status | compute_s | memory_s | "
           "collective_s | dominant | 6ND/FLOPs | note |")
    sep = "|" + "---|" * 10
    out = [hdr, sep]
    for r in rows:
        if r.status == "ok":
            out.append(
                f"| {r.arch} | {r.shape} | {r.mesh} | ok "
                f"| {r.compute_s:.4f} | {r.memory_s:.4f} "
                f"| {r.collective_s:.4f} | **{r.dominant}** "
                f"| {r.useful_ratio:.2f} | |")
        else:
            out.append(f"| {r.arch} | {r.shape} | {r.mesh} | {r.status} "
                       f"| | | | | | {r.note[:80]} |")
    return "\n".join(out)


def main(argv=None) -> int:
    import sys

    argv = sys.argv[1:] if argv is None else argv
    d = argv[0] if argv else "experiments/dryrun_torch"
    rows = table(d)
    if not rows:
        print(f"roofline: no dry-run reports in {d}", file=sys.stderr)
        return 1
    print(markdown_table(rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
