"""Plain float32 reference of the MoE family (Mixtral): pre-norm
blocks of GQA attention with rotary embeddings (and the configuration's
window) and a sparse SwiGLU mixture of experts, a final norm and the LM
head.

The mixture routes each token to its top-k experts by the softmax of a
float32 router, the k gates renormalised to sum to 1 (at least 1e-9).
A prefill caps each expert's load: with more than 4,096 (token, slot)
assignments in a forward, an expert takes at most ceil(int(1.25 k T) /
E) of them, the first ones in (token, slot) order, and the rest add
nothing. Decode is dropless (`capacity_factor=None`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import (attention_block, attention_weights, embed,
                    full_precision, head, linear, rmsnorm, silu, take,
                    weight)

DROPLESS_ASSIGNMENTS = 4096


def route(router_w, x, cfg, capacity_factor):
    """(gates (T, k), expert ids (T, k), kept (T, k)) for normed x (T, d)."""
    t, e, k = x.shape[0], cfg.n_experts, cfg.experts_per_token
    gates, ids = torch.softmax(x @ router_w.float(), -1).topk(k, -1)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    kept = torch.ones_like(ids, dtype=torch.bool)
    if capacity_factor is not None and t * k > DROPLESS_ASSIGNMENTS:
        cap = max(math.ceil(int(capacity_factor * k * t) / e), 1)
        onehot = F.one_hot(ids.reshape(-1), e)
        rank = (onehot.cumsum(0) * onehot).sum(-1) - 1
        kept = (rank < cap).reshape(t, k)
    return gates, ids, kept


def forward(cfg, params, batches, reads, control=False,
            capacity_factor=None):
    """Logits (B, len(read), vocab), float32, of each batch of token ids
    (B, L) at its positions `read`; each batch is one forward, so its
    tokens share the experts' capacity. Layer by layer over all batches,
    and expert by expert within a layer, so that one expert's weights
    are in float32 at a time."""
    full_precision()
    xs = [embed(params, t) for t in batches]
    for li in range(cfg.n_layers):
        lp = take(params["layers"], li)
        attn = attention_weights(lp["attn"], control)
        for i, x in enumerate(xs):
            xs[i] = x + attention_block(
                attn, rmsnorm(x, lp["norm1"]["scale"]), cfg, control)
        del attn
        normed = [rmsnorm(x, lp["norm2"]["scale"]).reshape(-1, cfg.d_model)
                  for x in xs]
        routes = [route(lp["moe"]["router"]["w"], h, cfg, capacity_factor)
                  for h in normed]
        outs = [torch.zeros_like(h) for h in normed]
        for e in range(cfg.n_experts):
            g, u, dn = (weight(lp["moe"][n][e], control)
                        for n in ("gate", "up", "down"))
            for h, (gates, ids, kept), out in zip(normed, routes, outs):
                tok, slot = ((ids == e) & kept).nonzero(as_tuple=True)
                if tok.numel() == 0:
                    continue
                he = h[tok]
                y = linear(silu(linear(he, g, control))
                           * linear(he, u, control), dn, control)
                out.index_add_(0, tok, y * gates[tok, slot, None])
            del g, u, dn
        xs = [x + o.reshape(x.shape) for x, o in zip(xs, outs)]
    return [head(cfg, params, x[:, r], control) for x, r in zip(xs, reads)]
