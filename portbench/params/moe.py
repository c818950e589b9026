"""Seeded weights of the MoE family (Mixtral) in `T.init_params`' layout:
per layer an RMSNorm, GQA attention projections, an RMSNorm and the
experts with their float32 router; the embedding table, the final norm
and the LM head. The draws' order is the layout's, one stacked tensor a
call; `order` then puts each layer's experts in a seed's order."""
from __future__ import annotations

import torch

from portbench.weights import EMBED_STD, Maker, permute_


def _moe(m: Maker, cfg, lead):
    d, e = cfg.d_model, cfg.n_experts
    dff = cfg.moe_d_ff or cfg.d_ff
    if cfg.moe_dense_residual:
        raise ValueError(f"{cfg.name}: a dense residual is not made here")
    return {"router": {"w": m.normal((*lead, d, e), d ** -0.5,
                                     torch.float32)},
            "gate": m.normal((*lead, e, d, dff), d ** -0.5),
            "up": m.normal((*lead, e, d, dff), d ** -0.5),
            "down": m.normal((*lead, e, dff, d), dff ** -0.5)}


def make(m: Maker, cfg) -> dict:
    """The model's weights, drawn from `m`."""
    lead = (cfg.n_layers,)
    layers = {"norm1": m.norm(*lead, cfg.d_model),
              "attn": m.attention(cfg, lead),
              "norm2": m.norm(*lead, cfg.d_model),
              "moe": _moe(m, cfg, lead)}
    params = {"embed": {"w": m.normal((cfg.vocab_size, cfg.d_model),
                                      EMBED_STD)},
              "layers": layers,
              "final_norm": m.norm(cfg.d_model),
              "lm_head": m.dense((), cfg.d_model, cfg.vocab_size)}
    return params


def order(params, cfg, rng) -> None:
    """Reorders each layer's experts, with their router columns, by a
    permutation drawn from `rng`, in place: the same model, whose
    experts take the same loads under other indices."""
    moe = params["layers"]["moe"]
    for layer in range(cfg.n_layers):
        perm = rng.permutation(cfg.n_experts)
        permute_(moe["router"]["w"][layer], perm, -1)
        for w in ("gate", "up", "down"):
            permute_(moe[w][layer], perm, 0)
