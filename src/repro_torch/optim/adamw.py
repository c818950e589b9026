"""AdamW from scratch, as `repro.optim.adamw` has it: float32 maths,
moments in `moment_dtype`, decoupled weight decay, global-norm clipping.

`init(params) -> state` and `update(grads, state, params, lr) -> (params,
state, grad_norm)` are functions over the parameter tree, and `update`
returns new tensors. `update(..., donate=True)` is the reference's
`jax.jit(..., donate_argnums=...)`: the caller gives up the old params
and state, and the results are written into their tensors, so a model
whose state fills the card is not held twice. The update is elementwise,
so a leaf is updated in slabs along its first dimension of at most
SLAB_ELEMENTS elements: the float32 temporaries of a full-width stacked
leaf (805 M elements for phi4-mini's MLP) would otherwise take 3 GB each.

On a mesh (DTensor leaves) the norm's sum of squares is a cross-shard
reduction, and each rank updates its own shards of the parameter and
its moments, which share the parameter's layout.

The maths follows the reference's expressions term by term; a divisor is
a tensor, never a Python float (on the card a division by a Python
scalar is a multiplication by its rounded reciprocal).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.launch import sharding as shd
from repro_torch.tree import leaves, tree_map


#: Largest slab of a leaf whose float32 temporaries AdamW holds at once.
SLAB_ELEMENTS = 1 << 26


def slabs(shape) -> list:
    """Slices along dim 0 covering a leaf of `shape` in runs of at most
    SLAB_ELEMENTS elements (whole rows; the whole leaf when it is small
    or has no dims)."""
    if not shape or shape[0] <= 1:
        return [...]
    row = max(1, SLAB_ELEMENTS // max(1, int(torch.Size(shape[1:]).numel())))
    return [slice(i, i + row) for i in range(0, shape[0], row)]


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable        # (grads, state, params, lr, donate=False) -> ...


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in the reference's order) of each
    leaf's float32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in leaves(tree)))


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """min(1, max_norm / max(norm, 1e-9))."""
    top = torch.full((), max_norm, dtype=norm.dtype, device=norm.device)
    return torch.clamp(top / torch.clamp(norm, min=1e-9), max=1.0)


def clipped(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """One leaf scaled as `clip_by_global_norm` scales it (rounded back to
    the gradient's dtype), in float32."""
    return (g.float() * scale).to(g.dtype).float()


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = clip_scale(norm, max_norm)
    return tree_map(lambda g: clipped(g, scale).to(g.dtype), grads), norm


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, clip_norm: float = 1.0,
          moment_dtype=torch.float32) -> Optimizer:
    def init(params):
        dev = leaves(params)[0].device
        zeros = lambda p: torch.zeros(p.shape, dtype=moment_dtype,  # noqa
                                      device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def update(grads, state, params, lr, donate: bool = False):
        # clipping is folded into each leaf's update: one leaf's float32
        # copy at a time instead of a clipped copy of every gradient
        gnorm = global_norm(grads)
        scale = clip_scale(gnorm, clip_norm)
        count = state["count"] + 1
        cf = count.float()
        bc1 = 1.0 - b1 ** cf
        bc2 = 1.0 - b2 ** cf

        sc, c1, c2 = (shd.local(t) for t in (scale, bc1, bc2))

        def upd(g, m, v, p):
            # on a mesh: the gradient and moments in the parameter's
            # layout, and each rank's shards updated in place (slicing a
            # sharded dim of a DTensor would move it)
            g, m, v = (shd.like(t, p) for t in (g, m, v))
            outs = (p, m, v) if donate else tuple(
                torch.empty_like(t) for t in (p, m, v))
            gl, ml, vl, pl = (shd.local(t) for t in (g, m, v, p))
            ol = [shd.local(t) for t in outs]
            for sl in slabs(pl.shape):
                g32 = clipped(gl[sl], sc)
                m_new = b1 * ml[sl].float() + (1 - b1) * g32
                v_new = b2 * vl[sl].float() + (1 - b2) * g32 * g32
                step = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
                step = step + weight_decay * pl[sl].float()
                p_new = pl[sl].float() - lr * step
                for out, new in zip(ol, (p_new, m_new, v_new)):
                    out[sl] = new
            return outs

        out = tree_map(upd, grads, state["m"], state["v"], params)
        pick = lambda i: tree_map(lambda _, o: o[i], params, out)  # noqa
        return pick(0), {"m": pick(1), "v": pick(2), "count": count}, gnorm

    return Optimizer(init=init, update=update)
