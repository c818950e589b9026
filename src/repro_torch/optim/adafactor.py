"""Adafactor, as `repro.optim.adafactor` has it: factored second-moment
statistics (row and column means) for leaves of two or more dimensions,
a full one for the others, no first moment, beta = 1 - count^-decay,
the RMS update clip, updated leaf by leaf. arctic-480b and qwen2-vl-72b
configure it. `update(..., donate=True)` writes into the old tensors, as
`adamw`'s does. On a mesh (DTensor leaves) the row and column means and
the update's RMS are cross-shard reductions, and each new statistic and
parameter keeps its old layout."""
from __future__ import annotations

import torch

from repro_torch.launch import sharding as shd
from repro_torch.optim.adamw import (Optimizer, clip_scale, clipped,
                                     global_norm)
from repro_torch.tree import leaves, tree_map


def store(old: torch.Tensor, new: torch.Tensor, donate: bool):
    """`new` as `old`'s dtype (and, on a mesh, in `old`'s layout):
    written into `old` when donated."""
    new = shd.like(new, old)
    return old.copy_(new) if donate else new.to(old.dtype)


def adafactor(eps: float = 1e-30, clip_threshold: float = 1.0,
              decay: float = 0.8, weight_decay: float = 0.0,
              clip_norm: float = 1.0) -> Optimizer:
    def init(params):
        def stat(p):
            z = lambda shape: torch.zeros(shape, dtype=torch.float32,  # noqa
                                          device=p.device)
            if p.ndim >= 2:
                return {"vr": z(p.shape[:-1]),
                        "vc": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}
        dev = leaves(params)[0].device
        return {"stats": tree_map(stat, params),
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def update(grads, state, params, lr, donate: bool = False):
        gnorm = global_norm(grads)
        scale = clip_scale(gnorm, clip_norm)
        count = state["count"] + 1
        beta = 1.0 - count.float() ** -decay
        floor = torch.full((), eps, device=gnorm.device)
        clip_t = torch.full((), clip_threshold, device=gnorm.device)

        def upd(g, st, p):
            g32 = clipped(shd.like(g, p), scale)
            g2 = g32 * g32 + eps
            if p.ndim >= 2:
                vr = beta * st["vr"] + (1 - beta) * g2.mean(-1)
                vc = beta * st["vc"] + (1 - beta) * g2.mean(-2)
                denom = (vr[..., None] * vc[..., None, :]
                         / torch.maximum(vr.mean(-1)[..., None, None],
                                         floor))
                step = g32 * torch.rsqrt(denom + eps)
                new_st = {"vr": store(st["vr"], vr, donate),
                          "vc": store(st["vc"], vc, donate)}
            else:
                v = beta * st["v"] + (1 - beta) * g2
                step = g32 * torch.rsqrt(v + eps)
                new_st = {"v": store(st["v"], v, donate)}
            rms = torch.sqrt(torch.mean(step * step) + eps)
            step = step / torch.clamp(rms / clip_t, min=1.0)
            p32 = p.float()
            p_new = p32 - lr * (step + weight_decay * p32)
            return store(p, p_new, donate), new_st

        out = tree_map(upd, grads, state["stats"], params)
        params_new = tree_map(lambda _, o: o[0], params, out)
        stats_new = tree_map(lambda _, o: o[1], params, out)
        return params_new, {"stats": stats_new, "count": count}, gnorm

    return Optimizer(init=init, update=update)
