"""Mixture-of-Experts FFN, as `repro.models.moe` has it: token-choice
top-k routing with a per-expert capacity, scatter into an (E, C, d)
buffer, the expert SwiGLUs as batched matrix products over E, and a
gather back weighted by the router gates; Arctic adds a dense SwiGLU
residual branch.

The router is float32 whatever the model's dtype. An assignment's slot
in its expert's buffer is its rank among the assignments to that expert
in flat (token, slot) order, and assignments past the capacity are
dropped: that order decides which are, so it is the reference's. The
buffer is written by assignment, not by a sum (kept slots are unique;
dropped assignments land in a spare row that is cut off, and read back
a spare row of zeros), and each token's k expert outputs are added in
slot order, so nothing here depends on the order in which the card's
atomics land. Every step is differentiable, and the backward keeps that
rule: a token's k copies are summed by a reshape, and the only rows
read more than once are the spare row's, whose gradient is dropped.

On a mesh the reference's eight sharding constraints apply (the routing
as its (T*k, E) transpose), and the buffer write and the gather back,
which DTensor has no rule for, run on local tensors (`shd.local_map`):
every rank writes the whole buffer from the gathered rows, and reads its
own assignments' rows back.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.launch import sharding as shd
from repro_torch.models.layers import dense_init, mlp_apply, mlp_init, normal

#: Token counts above this are dispatched in chunks along the length, and
#: the capacity is taken per chunk (`moe_apply`).
DISPATCH_CHUNK = 65536
#: Up to this many (token, slot) assignments the dispatch is dropless.
DROPLESS_ASSIGNMENTS = 4096


def moe_init(gen, cfg, dtype=torch.bfloat16, device=None, lead=()):
    """Router (d, E) in float32; expert `gate`/`up` (E, d, dff) and `down`
    (E, dff, d) in `dtype`, each drawn one (d, dff) matrix at a time so
    that a full-width stack needs no float32 copy of itself; Arctic's
    `dense_residual`, a SwiGLU MLP of width d_ff."""
    d = cfg.d_model
    dff = cfg.moe_d_ff or cfg.d_ff
    e = cfg.n_experts

    def experts(shape, std):
        w = torch.empty((*lead, e, *shape), dtype=dtype, device=device)
        if w.is_meta:
            return w
        for idx in np.ndindex(*lead, e):
            w[idx] = normal(gen, shape, std, dtype, device)
        return w

    p = {"router": dense_init(gen, d, e, dtype=torch.float32, device=device,
                              lead=lead),
         "gate": experts((d, dff), d ** -0.5),
         "up": experts((d, dff), d ** -0.5),
         "down": experts((dff, d), dff ** -0.5)}
    if cfg.moe_dense_residual:
        p["dense_residual"] = mlp_init(gen, d, cfg.d_ff, "swiglu", dtype,
                                       device, lead)
    return p


class Routing(NamedTuple):
    """One dispatch's routing over T tokens: float32 `logits` (T, E), the
    renormalized top-k `gates` (T, k) and `expert_ids` (T, k), each
    assignment's `pos` in its expert's buffer and whether it is kept
    (both (T*k,), flat (token, slot) order), and the `capacity`."""
    logits: torch.Tensor
    gates: torch.Tensor
    expert_ids: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    capacity: int


def route(params, xf, cfg, capacity_factor: float | None) -> Routing:
    """The router over xf: (T, d). `capacity_factor=None`, or at most
    DROPLESS_ASSIGNMENTS assignments, is dropless (capacity T*k); else
    the capacity is ceil(int(cf*k*T) / E), at least 1."""
    t = xf.shape[0]
    e, k = cfg.n_experts, cfg.experts_per_token
    logits = xf.float() @ params["router"]["w"]
    gates, expert_ids = torch.softmax(logits, -1).topk(k, -1)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    if capacity_factor is None or t * k <= DROPLESS_ASSIGNMENTS:
        capacity = t * k
    else:
        capacity = max(-(-int(capacity_factor * k * t) // e), 1)
    flat_e = expert_ids.reshape(-1)
    # one row an expert, so the running count scans the contiguous dim;
    # the reference's (T*k, E) layout is constrained as its transpose
    onehot = flat_e == torch.arange(e, device=xf.device)[:, None]  # (E, T*k)
    onehot = shd.constrain(onehot.mT, "moe_routing").mT
    pos_in_e = shd.constrain(onehot.cumsum(1).mT, "moe_routing").mT
    pos = pos_in_e.gather(0, flat_e[None])[0] - 1
    return Routing(logits, gates, expert_ids, pos, pos < capacity, capacity)


def moe_apply(params, x, cfg, capacity_factor: float | None = 1.25,
              dispatch_chunk: int = DISPATCH_CHUNK):
    """x: (B, L, d) -> (B, L, d). `capacity_factor=None` is dropless
    (the decode path's choice). Above `dispatch_chunk` tokens the
    dispatch runs on (B, chunk) slabs along the length whenever they
    divide L, with its capacity per slab, as the reference's scan does."""
    b, l, d = x.shape
    chunk_l = max(dispatch_chunk // max(b, 1), 1)
    if b * l > dispatch_chunk and l % chunk_l == 0 and l // chunk_l > 1:
        y = torch.cat([_moe_dispatch(params, x[:, i:i + chunk_l], cfg,
                                     capacity_factor)
                       for i in range(0, l, chunk_l)], dim=1)
    else:
        y = _moe_dispatch(params, x, cfg, capacity_factor)
    if "dense_residual" in params:              # Arctic
        y = y + mlp_apply(params["dense_residual"], x, "swiglu")
    return y


def _moe_dispatch(params, x, cfg, capacity_factor):
    """The dispatch over one (b, lc, d) slab; returns (b, lc, d)."""
    b, lc, d = x.shape
    t, e, k = b * lc, cfg.n_experts, cfg.experts_per_token
    xf = x.reshape(t, d)
    r = route(params, xf, cfg, capacity_factor)
    c = r.capacity
    # row e*c is the spare row the dropped assignments go to
    rows = torch.where(r.keep, r.expert_ids.reshape(-1) * c + r.pos, e * c)
    # each token k times in (token, slot) order: its backward sums the k
    # rows by a reshape, in a fixed order, not by an index_add
    contrib = shd.constrain(xf[:, None].expand(t, k, d).reshape(t * k, d),
                            "moe_tokens")
    # the buffer write has no DTensor sharding rule: on a mesh every rank
    # writes the whole buffer from the gathered rows
    buf = shd.local_map(lambda src, rows: _write_rows(src, rows, e * c + 1),
                        (contrib, rows), [(), ()], ())
    buf = shd.constrain(buf[:e * c].view(e, c, d), "moe_buffer")

    gate, up, down = (shd.fsdp_weight(params[n]) for n in ("gate", "up",
                                                           "down"))
    h = F.silu(torch.bmm(buf, gate)) * torch.bmm(buf, up)
    h = shd.constrain(h, "moe_hidden")
    out_buf = shd.constrain(torch.bmm(h, down), "moe_buffer")
    # the spare row of zeros is what a dropped assignment reads back; on
    # a mesh the buffer is gathered whole (it is read whole below, and a
    # capacity dim split over 'data' cannot be flattened into E*C)
    out = torch.cat([shd.replicate(out_buf).view(e * c, d),
                     x.new_zeros((1, d))])
    # each rank reads its own assignments' rows of the whole buffer
    gathered = shd.local_map(lambda rows, out: out[rows], (rows, out),
                             [(0,), (None,)], (0,))
    gathered = shd.constrain(gathered, "moe_tokens")
    w = r.gates.reshape(-1, 1).to(x.dtype)
    parts = (gathered * w).reshape(t, k, d)
    y = parts[:, 0]
    for j in range(1, k):                        # the reference's adds
        y = y + parts[:, j]
    return shd.constrain(y, "moe_tokens").reshape(b, lc, d)


def _write_rows(src, rows, n: int):
    """A zero (n, d) buffer with src's rows written at `rows` (unique but
    for the spare row, whose value is never read)."""
    buf = src.new_zeros((n, src.shape[1]))
    buf[rows] = src
    return buf


def aux_load_balance_loss(logits: torch.Tensor, expert_ids: torch.Tensor,
                          e: int) -> torch.Tensor:
    """Switch-style auxiliary loss over router `logits` (T, E) and the
    chosen `expert_ids` (T, k), for a training driver."""
    me = torch.softmax(logits, -1).mean(0)
    ce = F.one_hot(expert_ids[:, 0], e).float().mean(0)
    return e * (me * ce).sum()
