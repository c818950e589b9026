"""Roofline analysis from the port's dry-run artifacts, as
`repro.launch.roofline` has it, at the H100's peaks.

Hardware model (NVIDIA H100 SXM, per card):
    peak dense bf16 compute   989 TFLOP/s
    HBM3 bandwidth            3.35 TB/s
    collective bandwidth      50 GB/s: one 400 Gb/s NDR InfiniBand port a
                              GPU, the inter-node rate, since the (16, 16)
                              mesh spans more than one 8-card node. Inside
                              a node NVLink 4 gives 450 GB/s a direction
                              (`NVLINK_BW`), which the terms do not use.

Three terms per (arch x shape x mesh), in seconds:
    compute    = FLOPs_per_device / PEAK_FLOPS
    memory     = HBM_bytes_per_device / HBM_BW
    collective = collective_bytes_per_device / COLLECTIVE_BW

The FLOPs and HBM bytes come from the reference's ANALYTIC model
(`analytic_cost`, carried over verbatim: exact matmul accounting per
architecture, including remat recompute and attention/SSD chunk math),
so both packages give equal numbers for a cell. The collective bytes are
the dry-run's own count of the collectives DTensor issued
(`launch.dryrun`). The reference parses them from XLA's compiled HLO and
scales each while-loop body by its trip count, because a scanned layer
stack appears once there; the port's dry-run runs every layer, every
micro-batch and every remat recompute eagerly, so its count already
covers every call and needs no trip-count correction.

    PYTHONPATH=src python -m repro_torch.launch.roofline [--multi-pod]
"""
from __future__ import annotations

import argparse
import json
import os
from dataclasses import dataclass

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
COLLECTIVE_BW = 50e9
NVLINK_BW = 450e9


# --------------------------------------------------------------------------
# analytic FLOPs / HBM-bytes model
# --------------------------------------------------------------------------

@dataclass
class CostEstimate:
    flops_global: float
    hbm_bytes_global: float

    def per_device(self, chips: int):
        return self.flops_global / chips, self.hbm_bytes_global / chips


def _attn_flops(cfg, s_q: int, s_kv: int) -> float:
    """Per-token-batch=1 attention score+value FLOPs for one layer
    (2*s_q*s_kv*hd per head pair, x2 for scores and values)."""
    window = cfg.sliding_window
    if window is not None and s_kv > window:
        eff = window
    else:
        eff = s_kv
    # causal halves the average effective kv length for self-attention
    if s_q == s_kv:
        eff = eff / 2 if window is None else min(eff, s_kv / 2)
    return 2 * 2 * cfg.n_heads * s_q * eff * cfg.head_dim


def _layer_matmul_flops(cfg, tokens: float) -> float:
    """Weight-matmul FLOPs for one layer over `tokens` tokens (fwd)."""
    d = cfg.d_model
    hd = cfg.head_dim
    if cfg.family in ("ssm", "hybrid"):
        d_inner = cfg.ssm_expand * d
        n = cfg.ssm_state
        nheads = d_inner // cfg.ssm_head_dim
        proj = 2 * tokens * d * (2 * d_inner + 2 * n + nheads) \
            + 2 * tokens * d_inner * d
        # SSD chunked: intra-chunk (Q^2 terms) + state updates
        q = 128.0
        intra = 2 * tokens * q * (n + cfg.ssm_head_dim) * nheads
        inter = 2 * tokens * cfg.ssm_head_dim * n * nheads
        return proj + intra + inter
    attn_proj = 2 * tokens * d * hd * (cfg.n_heads * 2
                                       + cfg.n_kv_heads * 2)
    if cfg.n_experts > 0:
        eff = cfg.moe_d_ff or cfg.d_ff
        ffn = 2 * tokens * cfg.experts_per_token * 3 * d * eff
        if cfg.moe_dense_residual:
            ffn += 2 * tokens * 3 * d * cfg.d_ff
        ffn += 2 * tokens * d * cfg.n_experts          # router
    else:
        mult = 3 if cfg.mlp == "swiglu" else 2
        ffn = 2 * tokens * mult * d * cfg.d_ff
    return attn_proj + ffn


def analytic_cost(cfg, shape) -> CostEstimate:
    """Global FLOPs and HBM bytes for one step of the given shape."""
    b, s = shape.global_batch, shape.seq_len
    d, v = cfg.d_model, cfg.vocab_size
    p_active = cfg.active_param_count()

    if shape.kind == "decode":
        tokens = float(b)                       # one token per sequence
        layer = _layer_matmul_flops(cfg, tokens)
        attn = 0.0
        if cfg.family not in ("ssm",):
            s_kv = s if cfg.sliding_window is None else \
                min(s, cfg.sliding_window)
            n_attn = cfg.n_layers if cfg.family != "hybrid" else \
                cfg.n_layers // cfg.attn_every
            attn = n_attn * b * 2 * 2 * cfg.n_heads * s_kv * cfg.head_dim
        head = 2 * tokens * d * v
        flops = cfg.n_layers * layer + attn + head
        # decode HBM traffic: every active parameter + the KV/state cache
        # is read once per token
        cache_bytes = _cache_bytes(cfg, b, s)
        hbm = p_active * 2 + cache_bytes + tokens * d * 200
        return CostEstimate(flops, hbm)

    tokens = float(b) * s
    fwd = cfg.n_layers * _layer_matmul_flops(cfg, tokens)
    if cfg.family not in ("ssm",):
        n_attn = cfg.n_layers if cfg.family != "hybrid" else \
            cfg.n_layers // cfg.attn_every
        fwd += n_attn * b * _attn_flops(cfg, s, s)
    if cfg.family == "audio":
        ftok = float(b) * cfg.encoder_frames
        fwd += cfg.encoder_layers * _layer_matmul_flops(cfg, ftok)
        fwd += cfg.encoder_layers * b * _attn_flops(
            cfg, cfg.encoder_frames, cfg.encoder_frames)
        # cross attention in every decoder layer
        fwd += cfg.n_layers * (2 * tokens * d * cfg.head_dim
                               * cfg.n_kv_heads * 2
                               + b * 2 * 2 * cfg.n_heads * s
                               * cfg.encoder_frames * cfg.head_dim)
    fwd += 2 * tokens * d * v                   # lm head
    if shape.kind == "prefill":
        hbm = cfg.param_count() * 2 + tokens * d * 2 * 14 * 2
        return CostEstimate(fwd, hbm)
    # train: bwd = 2x fwd, remat = +1x fwd => 4x fwd total
    flops = 4 * fwd
    p_total = cfg.param_count()
    opt_mult = 12 if cfg.optimizer == "adamw" else 6
    hbm = (p_total * 2 * 3                      # weights fwd+bwd+remat
           + p_total * opt_mult                 # grads + moments r/w
           + cfg.n_layers * tokens * d * 2 * 14)  # activation traffic
    return CostEstimate(flops, hbm)


def _cache_bytes(cfg, b: int, s: int) -> float:
    if cfg.family == "ssm":
        d_inner = cfg.ssm_expand * cfg.d_model
        nheads = d_inner // cfg.ssm_head_dim
        return (cfg.n_layers * b * nheads * cfg.ssm_head_dim
                * cfg.ssm_state * 4)
    length = s if cfg.sliding_window is None else min(
        s, cfg.sliding_window)
    kv = cfg.n_layers * b * cfg.n_kv_heads * length * cfg.head_dim \
        * 2 * 2
    if cfg.family == "hybrid":
        groups = cfg.n_layers // cfg.attn_every
        d_inner = cfg.ssm_expand * cfg.d_model
        nheads = d_inner // cfg.ssm_head_dim
        kv = groups * b * cfg.n_kv_heads * s * cfg.head_dim * 2 * 2 \
            + cfg.n_layers * b * nheads * cfg.ssm_head_dim \
            * cfg.ssm_state * 4
    return kv


# --------------------------------------------------------------------------
# report
# --------------------------------------------------------------------------

def roofline_row(rec: dict, cfg, shape, chips: int = 256) -> dict:
    """The three terms of one dry-run record, with the analytic FLOPs and
    bytes per device and the record's collective bytes per device."""
    est = analytic_cost(cfg, shape)
    flops_dev, hbm_dev = est.per_device(chips)
    coll_dev = rec.get("collectives", {}).get("total_bytes", 0)
    t_compute = flops_dev / PEAK_FLOPS
    t_memory = hbm_dev / HBM_BW
    t_coll = coll_dev / COLLECTIVE_BW
    dominant = max((t_compute, "compute"), (t_memory, "memory"),
                   (t_coll, "collective"))[1]
    # MODEL_FLOPS: 6*N_active*D for training (fwd+bwd), 2*N_active*D for
    # inference, D = tokens processed this step.
    tokens = (shape.global_batch * shape.seq_len
              if shape.kind in ("train", "prefill")
              else shape.global_batch)
    mult = 6 if shape.kind == "train" else 2
    model_flops = mult * cfg.active_param_count() * tokens
    bound = max(t_compute, t_memory, t_coll)
    return {
        "arch": cfg.name, "shape": shape.name,
        "flops_dev": flops_dev, "hbm_dev": hbm_dev,
        "coll_dev": coll_dev,
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll, "dominant": dominant,
        "model_flops_global": model_flops,
        # how much of the counted compute is "useful" (catches remat /
        # routing / recompute waste)
        "useful_ratio": model_flops / max(est.flops_global, 1),
        # fraction of roofline under perfect overlap (1.0 = compute-
        # bound at peak) and under no overlap (serial lower bound)
        "roofline_overlapped": t_compute / max(bound, 1e-12),
        "roofline_serial": t_compute / max(
            t_compute + t_memory + t_coll, 1e-12),
    }


def load_artifacts(artifact_dir: str) -> list:
    out = []
    for name in sorted(os.listdir(artifact_dir)):
        if name.endswith(".json"):
            with open(os.path.join(artifact_dir, name)) as f:
                out.append(json.load(f))
    return out


def report(artifact_dir: str, multi_pod: bool = False) -> list:
    """One row a dry-run artifact of the chosen mesh: the roofline terms
    beside the dry-run's own per-device FLOPs and argument bytes."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.configs.registry import ARCHS
    chips = 512 if multi_pod else 256
    rows = []
    for rec in load_artifacts(artifact_dir):
        if rec.get("multi_pod") != multi_pod:
            continue
        tag = f"{rec['arch']}/{rec['shape']}/{rec['strategy']}"
        if rec["status"] != "ok":
            why = rec.get("reason") or rec.get("error", "")
            print(f"roofline/{tag}: {rec['status'].upper()} {why[:80]}")
            continue
        row = roofline_row(rec, ARCHS[rec["arch"]], SHAPES[rec["shape"]],
                           chips=chips)
        row.update(strategy=rec["strategy"],
                   dryrun_flops_dev=rec["cost"]["flops"],
                   argument_bytes_dev=rec["memory"]["argument_bytes"])
        rows.append(row)
        print(f"roofline/{tag}: t_comp={row['t_compute_s']:.4f}s "
              f"t_mem={row['t_memory_s']:.4f}s "
              f"t_coll={row['t_collective_s']:.4f}s "
              f"dom={row['dominant']} "
              f"roofline={row['roofline_overlapped']:.2f} "
              f"useful={row['useful_ratio']:.2f} "
              f"flops/dev analytic={row['flops_dev']:.3g} "
              f"dryrun={row['dryrun_flops_dev']:.3g} "
              f"args/dev={row['argument_bytes_dev'] / 2**30:.2f}GiB")
    return rows


def main(argv=None):
    from repro_torch.launch.dryrun import ARTIFACT_DIR
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifacts", default=ARTIFACT_DIR)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None, help="write the rows as JSON")
    args = ap.parse_args(argv)
    if not os.path.isdir(args.artifacts):
        raise SystemExit(f"no dry-run artifacts in {args.artifacts}: run "
                         "`python -m repro_torch.launch.dryrun` first")
    rows = report(args.artifacts, args.multi_pod)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
