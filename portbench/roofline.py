"""The benchmark's frozen roofline arithmetic: the H100's data-sheet
peaks, the least time of the flash-attention and SSD kernels at a shape
(copied from `chip_smoke.py`, where PRs 23-28 measured against it), and
the operations and bytes of a whole model step computed from shapes.

Everything here counts what the computation needs, not what a kernel
happens to do: each input byte read once and each output byte written
once, and the operations of the work these inputs require (a causal
mask's kept pairs, the two chosen experts of a token, the KV positions
already written).
"""
from __future__ import annotations

#: H100 SXM data-sheet peaks: HBM bytes/s and dense bf16 tensor-core
#: operations/s (NVIDIA's data sheet, no sparsity, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
BF16 = 2                    # bytes of a bf16 element
F32 = 4


def bound(nbytes: float, ops: float, ops_per_s: float = BF16_OPS_PER_S
          ) -> tuple[float, str]:
    """Least ms for `nbytes` moved once and `ops` at `ops_per_s`, and
    which of the two bounds it."""
    by = nbytes / HBM_BYTES_PER_S * 1e3
    op = ops / ops_per_s * 1e3
    return (by, "bytes") if by >= op else (op, "operations")


def causal_pairs(lq: int, lk: int, window: int | None = None) -> int:
    """(query, key) pairs a causal mask keeps, queries aligned to the end
    of the keys; with a window, only keys less than `window` behind."""
    pairs = 0
    for i in range(lq):
        last = lk - lq + i                   # the row's newest key
        if last < 0:
            continue
        first = 0 if window is None else max(0, last - window + 1)
        pairs += last - first + 1
    return pairs


def flash_ops(b, h, lq, lk, d, window=None) -> float:
    """The QK and PV products of the (q, k) pairs the causal mask keeps
    (2 D operations each for QK^T and for PV)."""
    return 4 * d * causal_pairs(lq, lk, window) * b * h


def flash_bound_ms(b, h, lq, lk, d, itemsize=BF16, hkv=None,
                   window=None) -> tuple[float, str]:
    """q, k, v read once and o written once (k and v at `hkv` heads, h by
    default), against `flash_ops` on the bf16 tensor cores."""
    hkv = h if hkv is None else hkv
    return bound(b * (2 * h * lq + 2 * hkv * lk) * d * itemsize,
                 flash_ops(b, h, lq, lk, d, window))


def ssd_ops(b, l, h, p, n, chunk=128) -> float:
    """The dual form's products at the reference's chunk (per chunk and
    head: C B^T 2Q^2N, the masked-decay product 2Q^2P, C S^T and the
    state update 2QPN each)."""
    nc = -(-l // chunk)
    return b * h * nc * (2 * chunk * chunk * (n + p) + 4 * chunk * p * n)


def ssd_bound_ms(b, l, h, p, n, itemsize=BF16) -> tuple[float, str]:
    """x read and y written once, dt, B, C, a, d read once, against
    `ssd_ops` on the bf16 tensor cores."""
    nbytes = 2 * b * l * h * p * itemsize + b * l * h * F32 \
        + 2 * b * l * n * itemsize + 2 * h * F32
    return bound(nbytes, ssd_ops(b, l, h, p, n))


# --------------------------------------------------------------------------
# whole model steps
# --------------------------------------------------------------------------

def _attention_family(cfg) -> None:
    """The whole-step counts below are for models of attention and MLP
    or expert blocks; another family would need its own."""
    if cfg.family not in ("dense", "moe"):
        raise ValueError(f"{cfg.name}: no step arithmetic for the family "
                         f"{cfg.family!r}")


def _attn_weights(cfg) -> int:
    """Elements of one attention block's projections."""
    hd = cfg.head_dim
    return cfg.d_model * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd \
        + cfg.n_heads * hd * cfg.d_model


def layer_macs_per_token(cfg) -> int:
    """Multiply-adds of the weights one token uses in one layer block
    (the chosen experts only, for MoE), without the LM head."""
    _attention_family(cfg)
    d = cfg.d_model
    macs = _attn_weights(cfg)
    if cfg.n_experts:
        dff = cfg.moe_d_ff or cfg.d_ff
        macs += d * cfg.n_experts + cfg.experts_per_token * 3 * d * dff
    else:
        macs += (3 if cfg.mlp == "swiglu" else 2) * d * cfg.d_ff
    return macs


def prefill_flops(cfg, b: int, l: int) -> float:
    """Operations of one batch prefill of `b` prompts of `l` tokens that
    returns the last token's logits: every token through every block,
    causal attention over the kept pairs, and the LM head once a
    prompt."""
    ops = 2.0 * b * l * cfg.n_layers * layer_macs_per_token(cfg)
    ops += cfg.n_layers * flash_ops(b, cfg.n_heads, l, l, cfg.head_dim,
                                    cfg.sliding_window)
    return ops + 2.0 * b * cfg.d_model * cfg.vocab_size


def weight_bytes(cfg) -> float:
    """Bytes of every weight a decode step reads once, in bf16 (the MoE
    router in float32), without the embedding table, of which a step
    reads only its tokens' rows. Every expert counts: a step of 64 tokens
    makes 128 assignments over 8 experts, and an expert that none of
    them picks (odds under 1e-7 a layer at even routing) would still be
    counted here."""
    _attention_family(cfg)
    d = cfg.d_model
    per_layer = BF16 * (_attn_weights(cfg) + 2 * d)
    if cfg.n_experts:
        dff = cfg.moe_d_ff or cfg.d_ff
        per_layer += F32 * d * cfg.n_experts \
            + BF16 * cfg.n_experts * 3 * d * dff
    else:
        per_layer += BF16 * (3 if cfg.mlp == "swiglu" else 2) * d * cfg.d_ff
    return cfg.n_layers * per_layer + BF16 * (d * cfg.vocab_size + d)


def decode_step_bound_ms(cfg, b: int, pos: int) -> tuple[float, str]:
    """Least ms of one decode step of `b` tokens at position `pos` (the
    cache holds pos + 1 keys after the step's write): the weights read
    once, the tokens' embedding rows, the KV cache's written positions
    read once and the new keys and values written, the logits written;
    against the weights' multiply-adds for b tokens, attention over the
    pos + 1 keys and the LM head."""
    hd, kv = cfg.head_dim, pos + 1
    if cfg.sliding_window is not None:
        kv = min(kv, cfg.sliding_window)
    cache = 2 * cfg.n_layers * b * cfg.n_kv_heads * hd * BF16
    nbytes = weight_bytes(cfg) + b * cfg.d_model * BF16 + cache * kv \
        + cache + b * cfg.vocab_size * BF16
    ops = 2.0 * b * (cfg.n_layers * layer_macs_per_token(cfg)
                     + cfg.d_model * cfg.vocab_size) \
        + cfg.n_layers * 4.0 * b * cfg.n_heads * hd * kv
    return bound(nbytes, ops)
