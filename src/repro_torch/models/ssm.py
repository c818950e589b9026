"""Mamba2 (SSD) block, as `repro.models.ssm` has it: in-projection ->
short causal conv -> SiLU -> selective state-space scan -> gated
out-projection.

The prefill scan has two implementations: 'chunked', the SSD dual form
in plain torch at chunk 128 (the reference's 'xla_chunked'), and 'cuda',
the hand-written kernel (`repro_torch.kernels.ssd`). Decode runs the
exact per-step recurrence on a {conv, ssm} state in O(1) per token.

Dtypes follow the reference's promotion: the float32 conv state joined
with the bf16 input is float32, and the float32 scan output times the
bf16 gate is float32 until the out-projection casts it back.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.launch import sharding as shd
from repro_torch.models.attention import check_impl
from repro_torch.models.layers import dense, dense_init, normal, softplus

CONV_WIDTH = 4


def ssm_init(gen, cfg, dtype=torch.bfloat16, device=None, lead=()):
    d = cfg.d_model
    d_inner = cfg.ssm_expand * d
    n = cfg.ssm_state
    nheads = d_inner // cfg.ssm_head_dim
    conv_ch = d_inner + 2 * n          # conv over x, B, C streams
    f32 = dict(dtype=torch.float32, device=device)
    a_log = torch.log(torch.linspace(1.0, 16.0, nheads, **f32))
    return {
        # in_proj -> [z (d_inner), x (d_inner), B (n), C (n), dt (nheads)]
        "in_proj": dense_init(gen, d, 2 * d_inner + 2 * n + nheads,
                              dtype=dtype, device=device, lead=lead),
        "conv_w": normal(gen, (*lead, CONV_WIDTH, conv_ch), 0.2, dtype,
                         device),
        "conv_b": torch.zeros((*lead, conv_ch), dtype=dtype, device=device),
        "a_log": a_log.expand(*lead, nheads).clone(),
        "dt_bias": torch.zeros((*lead, nheads), **f32),
        "d_skip": torch.ones((*lead, nheads), **f32),
        "out_proj": dense_init(gen, d_inner, d, dtype=dtype, device=device,
                               lead=lead),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv: x (B, L, C), w (W, C)."""
    width = w.shape[0]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = xp[:, 0:x.shape[1]] * w[0]
    for i in range(1, width):
        out = out + xp[:, i:i + x.shape[1]] * w[i]
    return out + b


def _dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    return d_inner, cfg.ssm_state, cfg.ssm_head_dim, \
        d_inner // cfg.ssm_head_dim


def ssm_apply(params, x, cfg, impl="chunked", state=None):
    """x: (B, L, d). With `state` (decode), L == 1 and the exact
    recurrence advances {conv, ssm}. Returns (y, new_state or None)."""
    d_inner, n, hd, nheads = _dims(cfg)
    zxbcdt = dense(params["in_proj"], x)
    z, xin, bm, cm, dt = torch.split(
        zxbcdt, [d_inner, d_inner, n, n, nheads], dim=-1)
    conv_in = torch.cat([xin, bm, cm], dim=-1)
    a = -torch.exp(params["a_log"])
    dt = softplus(dt.float() + params["dt_bias"])            # (B, L, H)

    if state is not None:
        conv_state = state["conv"]                           # (B, W-1, C)
        work = torch.promote_types(conv_state.dtype, conv_in.dtype)
        window = torch.cat([conv_state.to(work), conv_in.to(work)], dim=1)
        wdt = torch.promote_types(work, params["conv_w"].dtype)
        conv_out = torch.einsum("bwc,wc->bc", window.to(wdt),
                                params["conv_w"].to(wdt)) + params["conv_b"]
        conv_out = F.silu(conv_out)[:, None]                 # (B, 1, C)
        xs, bs, cs = torch.split(conv_out, [d_inner, n, n], dim=-1)
        xh = xs.reshape(-1, nheads, hd)                      # (B, H, P)
        dt1 = dt[:, 0]                                       # (B, H)
        decay = torch.exp(a[None] * dt1)
        inject = dt1[..., None, None] * xh[..., None] \
            * bs[:, 0][:, None, None, :]
        s_new = state["ssm"] * decay[..., None, None] + inject
        y = torch.einsum("bhpn,bn->bhp", s_new, cs[:, 0])
        y = y + params["d_skip"][None, :, None] * xh
        y = y.reshape(-1, 1, d_inner) * F.silu(z)
        out = dense(params["out_proj"], y.to(x.dtype))
        return out, {"conv": window[:, 1:], "ssm": s_new}

    check_impl(impl)
    # independent along the batch: on a mesh, each rank's batch shard
    conv_out = F.silu(shd.local_map(
        _causal_conv, (conv_in, params["conv_w"], params["conv_b"]),
        [(0,), (None,), (None,)], (0,)))
    xs, bs, cs = torch.split(conv_out, [d_inner, n, n], dim=-1)
    bsz, l, _ = xs.shape
    xh = shd.constrain(xs.reshape(bsz, l, nheads, hd), "ssm_heads")
    if impl == "cuda":
        from repro_torch.kernels.ssd.ops import ssd
        if not xh.is_cuda:
            raise ValueError(f"impl='cuda' needs CUDA tensors, got "
                             f"{xh.device}")
        y = ssd(xh, dt, a, bs, cs, params["d_skip"])
    else:
        from repro_torch.kernels.ssd.ref import ssd_chunked
        # independent along (batch, head): on a mesh, each rank's shards
        y = shd.local_map(
            lambda *t: ssd_chunked(*t, chunk=128),
            (xh, dt, a, bs, cs, params["d_skip"]),
            [(0, 2), (0, 2), (None, 0), (0, None), (0, None), (None, 0)],
            (0, 2))
    y = y.reshape(bsz, l, d_inner) * F.silu(z)
    return dense(params["out_proj"], y.to(x.dtype)), None


def init_ssm_state(cfg, batch: int, n_layers: int, dtype=torch.float32,
                   device=None):
    d_inner, n, hd, nheads = _dims(cfg)
    conv_ch = d_inner + 2 * n
    return {
        "conv": torch.zeros((n_layers, batch, CONV_WIDTH - 1, conv_ch),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((n_layers, batch, nheads, hd, n), dtype=dtype,
                           device=device),
    }
