"""Whole-step counts of the dense family: pre-norm blocks of attention
and an MLP, a final norm and the LM head.

The stack's counts (`stack_*`) take a block's feed-forward counts from
the caller, so that another family of such blocks (moe) brings only its
own. Each counts what the step needs, as `portbench.roofline` does.
"""
from __future__ import annotations

from portbench import roofline as rf


def ffn_macs(cfg) -> int:
    """Multiply-adds of the MLP one token uses in one block."""
    return (3 if cfg.mlp == "swiglu" else 2) * cfg.d_model * cfg.d_ff


def ffn_bytes(cfg) -> int:
    """Bytes of one block's MLP weights, in bf16."""
    return rf.BF16 * ffn_macs(cfg)


def layer_macs_per_token(cfg) -> int:
    return stack_layer_macs(cfg, ffn_macs(cfg))


def prefill_flops(cfg, b: int, l: int) -> float:
    return stack_prefill_flops(cfg, b, l, layer_macs_per_token(cfg))


def weight_bytes(cfg) -> float:
    return stack_weight_bytes(cfg, ffn_bytes(cfg))


def decode_step_bound_ms(cfg, b: int, pos: int) -> tuple[float, str]:
    return stack_decode_bound_ms(cfg, b, pos, weight_bytes(cfg),
                                 layer_macs_per_token(cfg))


def stack_layer_macs(cfg, ffn: int) -> int:
    """Multiply-adds of the weights one token uses in one block (`ffn`
    those of its feed-forward part), without the LM head."""
    return rf.attn_weights(cfg) + ffn


def stack_prefill_flops(cfg, b: int, l: int, layer_macs: int) -> float:
    """Operations of one batch prefill of `b` prompts of `l` tokens that
    returns the last token's logits: every token through every block,
    causal attention over the kept pairs, and the LM head once a
    prompt."""
    ops = 2.0 * b * l * cfg.n_layers * layer_macs
    ops += cfg.n_layers * rf.flash_ops(b, cfg.n_heads, l, l, cfg.head_dim,
                                       cfg.sliding_window)
    return ops + 2.0 * b * cfg.d_model * cfg.vocab_size


def stack_weight_bytes(cfg, ffn: int) -> float:
    """Bytes of every weight a decode step reads once, in bf16 (`ffn` a
    block's feed-forward weights), without the embedding table, of which
    a step reads only its tokens' rows."""
    d = cfg.d_model
    per_layer = rf.BF16 * (rf.attn_weights(cfg) + 2 * d) + ffn
    return cfg.n_layers * per_layer + rf.BF16 * (d * cfg.vocab_size + d)


def stack_decode_bound_ms(cfg, b: int, pos: int, wbytes: float,
                          layer_macs: int) -> tuple[float, str]:
    """Least ms of one decode step of `b` tokens at position `pos` (the
    cache holds pos + 1 keys after the step's write): the weights
    (`wbytes`) read once, the tokens' embedding rows, the KV cache's
    written positions read once and the new keys and values written, the
    logits written; against the weights' multiply-adds for b tokens,
    attention over the pos + 1 keys and the LM head."""
    hd, kv = cfg.head_dim, pos + 1
    if cfg.sliding_window is not None:
        kv = min(kv, cfg.sliding_window)
    cache = 2 * cfg.n_layers * b * cfg.n_kv_heads * hd * rf.BF16
    nbytes = wbytes + b * cfg.d_model * rf.BF16 + cache * kv \
        + cache + b * cfg.vocab_size * rf.BF16
    ops = 2.0 * b * (cfg.n_layers * layer_macs
                     + cfg.d_model * cfg.vocab_size) \
        + cfg.n_layers * 4.0 * b * cfg.n_heads * hd * kv
    return rf.bound(nbytes, ops)
