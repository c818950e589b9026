"""int8 gradient compression with error feedback, as
`repro.optim.grad_compress` has it: per-tensor symmetric quantization to
int8 (round half to even, as `jnp.round`), dequantized after.
`compress_decompress` is the stateless form a train step applies;
`make_error_feedback` carries the quantization residual."""
from __future__ import annotations

import torch

from repro_torch.tree import tree_map


def _quant(g):
    g32 = g.float()
    # a tensor divisor: the card divides by a Python scalar as a
    # multiplication by its rounded reciprocal
    levels = torch.full((), 127.0, device=g.device)
    scale = torch.clamp(torch.max(torch.abs(g32)), min=1e-12) / levels
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant(q, scale):
    return q.float() * scale


def compress_decompress(grads):
    def f(g):
        q, s = _quant(g)
        return _dequant(q, s).to(g.dtype)
    return tree_map(f, grads)


def make_error_feedback():
    """Returns (init, apply): apply(grads, err) -> (compressed, new_err)
    with error feedback: e' = g + e - Q(g + e)."""
    def init(params):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)

    def apply(grads, err):
        def f(g, e):
            corrected = g.float() + e
            q, s = _quant(corrected)
            deq = _dequant(q, s)
            return deq.to(g.dtype), corrected - deq
        out = tree_map(f, grads, err)
        return (tree_map(lambda _, o: o[0], grads, out),
                tree_map(lambda _, o: o[1], grads, out))

    return init, apply
