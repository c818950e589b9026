"""Whole-step counts of the MoE family (Mixtral): the dense family's
stack of attention blocks, each with a sparse mixture of experts in
place of the MLP."""
from __future__ import annotations

from portbench import roofline as rf
from portbench.arithmetic.dense import (stack_decode_bound_ms,
                                        stack_layer_macs,
                                        stack_prefill_flops,
                                        stack_weight_bytes)


def ffn_macs(cfg) -> int:
    """Multiply-adds one token uses in one block's mixture: the float32
    router over every expert and the SwiGLU of the chosen experts
    only."""
    d, dff = cfg.d_model, cfg.moe_d_ff or cfg.d_ff
    return d * cfg.n_experts + cfg.experts_per_token * 3 * d * dff


def ffn_bytes(cfg) -> int:
    """Bytes of one block's mixture: the router in float32 and every
    expert in bf16. Every expert counts: a decode step of 64 tokens makes
    128 assignments over 8 experts, and an expert that none of them
    picks (odds under 1e-7 a layer at even routing) would still be
    counted here."""
    d, dff = cfg.d_model, cfg.moe_d_ff or cfg.d_ff
    return rf.F32 * d * cfg.n_experts + rf.BF16 * cfg.n_experts * 3 * d * dff


def layer_macs_per_token(cfg) -> int:
    return stack_layer_macs(cfg, ffn_macs(cfg))


def prefill_flops(cfg, b: int, l: int) -> float:
    return stack_prefill_flops(cfg, b, l, layer_macs_per_token(cfg))


def weight_bytes(cfg) -> float:
    return stack_weight_bytes(cfg, ffn_bytes(cfg))


def decode_step_bound_ms(cfg, b: int, pos: int) -> tuple[float, str]:
    return stack_decode_bound_ms(cfg, b, pos, weight_bytes(cfg),
                                 layer_macs_per_token(cfg))
