"""GQA attention with RoPE / M-RoPE, optional QKV bias, sliding window,
cross-attention (keys and values from another sequence) and a KV-cache
decode branch, as `repro.models.attention` has it, with three prefill
implementations:

  * 'naive'   — full (Lq, Lk) score matrix;
  * 'chunked' — flash-style online softmax over Q and KV blocks in plain
                torch (the reference's 'xla_chunked');
  * 'cuda'    — the hand-written kernel (`repro_torch.kernels.
                flash_attention`), which reads kv head h // rep instead of
                repeating the keys.

'pallas' has no meaning here and raises. The reference's sharding
constraints are kept (`launch.sharding.constrain`: the identity without
a mesh); on a mesh the attention core runs on each rank's (batch, head)
shards (`shd.local_map`).

Decode attends the new token against the cache and writes its keys and
values into the cache tensors in place (the reference returns new
arrays): serving owns its cache, and an in-place write keeps one copy of
it on the card.
"""
from __future__ import annotations

import torch

from repro_torch.launch import sharding as shd
from repro_torch.models.layers import apply_mrope, apply_rope, dense, dense_init

NEG = -1e30
IMPLS = ("naive", "chunked", "cuda")


def check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}: one of {IMPLS} ('cuda' "
                         "is the hand-written kernel)")


def attention_init(gen, cfg, dtype=torch.bfloat16, device=None, lead=()):
    d, hd = cfg.d_model, cfg.head_dim
    kw = dict(dtype=dtype, device=device, lead=lead)
    return {
        "wq": dense_init(gen, d, cfg.n_heads * hd, bias=cfg.qkv_bias, **kw),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias,
                         **kw),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias,
                         **kw),
        "wo": dense_init(gen, cfg.n_heads * hd, d, **kw),
    }


def _split_heads(x, n_heads, hd):
    b, l, _ = x.shape
    x = shd.splittable(x, -1, n_heads)
    return x.reshape(b, l, n_heads, hd).transpose(1, 2)


def _merge_heads(x):
    b, h, l, hd = x.shape
    return x.transpose(1, 2).reshape(b, l, h * hd)


def _apply_positions(q, k, cfg, positions):
    if cfg.mrope:
        if positions.ndim == 2:                  # text-only: t = h = w
            positions = positions[:, None, :].expand(
                positions.shape[0], 3, positions.shape[1])
        q = apply_mrope(q, positions, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, positions, cfg.mrope_sections, cfg.rope_theta)
    elif cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k


def _neg(device):
    return torch.full((), NEG, device=device)


def _naive_attention(q, k, v, causal, window):
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    lq, lk = q.shape[2], k.shape[2]
    qi = torch.arange(lq, device=q.device)[:, None]
    kj = torch.arange(lk, device=q.device)[None, :]
    mask = torch.ones((lq, lk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qi >= kj
    if window is not None:
        mask &= (qi - kj) < window
    s = torch.where(mask, s, _neg(q.device))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def _chunked_attention(q, k, v, causal, window, bq=512, bk=1024):
    """Flash-style double loop in plain torch (float32 accumulators)."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    bq, bk = min(bq, lq), min(bk, lk)
    scale = d ** -0.5
    q_offset = lk - lq
    neg = _neg(q.device)
    outs = []
    for q0 in range(0, lq, bq):
        qb = q[:, :, q0:q0 + bq]
        rows = torch.arange(qb.shape[2], device=q.device)[:, None]
        qpos = q0 + rows + q_offset
        m = torch.full((b, h, qb.shape[2], 1), NEG, device=q.device)
        l = torch.zeros((b, h, qb.shape[2], 1), device=q.device)
        acc = torch.zeros((b, h, qb.shape[2], d), device=q.device)
        for k0 in range(0, lk, bk):
            kb, vb = k[:, :, k0:k0 + bk], v[:, :, k0:k0 + bk]
            s = torch.einsum("bhqd,bhkd->bhqk", qb, kb).float() * scale
            kpos = k0 + torch.arange(kb.shape[2], device=q.device)[None, :]
            mask = torch.ones_like(qpos >= kpos)
            if causal:
                mask &= qpos >= kpos
            if window is not None:
                mask &= (qpos - kpos) < window
            s = torch.where(mask, s, neg)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.einsum(
                "bhqk,bhkd->bhqd", p.to(qb.dtype), vb).float()
            m = m_new
        outs.append((acc / l.clamp(min=1e-30)).to(q.dtype))
    return torch.cat(outs, dim=2)


def _decode_attention(q, k, v, cfg, kv_cache, cache_index: int):
    """Write the new token's k, v into the cache (in place) and attend q
    against it. The query heads are grouped per kv head, so the cache is
    never repeated for GQA."""
    hd = cfg.head_dim
    lk = kv_cache["k"].shape[2]
    rolling = "pos" in kv_cache
    slot = cache_index % lk if rolling else cache_index
    ck, cv = kv_cache["k"], kv_cache["v"]
    ck[:, :, slot] = k[:, :, 0].to(ck.dtype)
    cv[:, :, slot] = v[:, :, 0].to(cv.dtype)
    ck = shd.constrain(ck, "kv_cache")
    cv = shd.constrain(cv, "kv_cache")
    dev = q.device
    if rolling:
        pos_buf = kv_cache["pos"]
        pos_buf[slot] = cache_index
        valid = (pos_buf >= 0) & (pos_buf <= cache_index)
        if cfg.sliding_window is not None:
            valid &= (cache_index - pos_buf) < cfg.sliding_window
    else:
        kpos = torch.arange(lk, device=dev)
        valid = kpos <= slot
        if cfg.sliding_window is not None:
            valid &= (slot - kpos) < cfg.sliding_window
    # independent along the batch: on a mesh, each rank's batch shard
    # against its cache rows, gathered whole along the heads and S
    return shd.local_map(lambda q, ck, cv, valid: _decode_core(
        q, ck, cv, valid, cfg), (q, ck, cv, valid),
        [(0,), (0,), (0,), (None,)], (0,))


def _decode_core(q, ck, cv, valid, cfg):
    hd = cfg.head_dim
    rep = cfg.n_heads // cfg.n_kv_heads
    b, _, lq, _ = q.shape
    # the reference's einsums promote (a bf16 cache against float32
    # queries computes in float32); torch's matmul does not, so cast
    work = torch.promote_types(q.dtype, ck.dtype)
    qg = q.reshape(b, cfg.n_kv_heads, rep * lq, hd).to(work)
    s = torch.einsum("bgqd,bgkd->bgqk", qg, ck.to(work)).float() \
        * hd ** -0.5
    s = torch.where(valid, s, _neg(q.device))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    work = torch.promote_types(p.dtype, cv.dtype)
    out = torch.einsum("bgqk,bgkd->bgqd", p.to(work), cv.to(work))
    return out.reshape(b, cfg.n_heads, lq, hd)


def attention_apply(params, x, cfg, positions, causal=True, impl="chunked",
                    kv_cache=None, cache_index=None, x_kv=None):
    """Attention over x: (B, L, d) at `positions` (B, L). With
    `kv_cache` (decode), x is the single new token (L = 1) and
    `cache_index` (an int) its position; the cache dict (k, v:
    (B, Hkv, S, hd)[, pos: (S,)]) is updated in place. With `x_kv`
    (B, Lk, d) it is cross-attention (the whisper decoder): keys and
    values come from x_kv, with no rotary; the caller passes
    causal=False. Returns (out, kv_cache or None)."""
    check_impl(impl)
    hd = cfg.head_dim
    src = x if x_kv is None else x_kv
    q = _split_heads(dense(params["wq"], x), cfg.n_heads, hd)
    k = _split_heads(dense(params["wk"], src), cfg.n_kv_heads, hd)
    v = _split_heads(dense(params["wv"], src), cfg.n_kv_heads, hd)
    q = shd.constrain(q, "attn_heads")
    k = shd.constrain(k, "attn_kv_heads")
    v = shd.constrain(v, "attn_kv_heads")
    if x_kv is None:
        if kv_cache is not None:
            positions = torch.full((x.shape[0], 1), cache_index,
                                   dtype=torch.int32, device=x.device)
        q, k = _apply_positions(q, k, cfg, positions)

    if kv_cache is not None:
        out = _decode_attention(q, k, v, cfg, kv_cache, cache_index)
        return dense(params["wo"], _merge_heads(out)), kv_cache

    window = cfg.sliding_window
    if impl == "cuda":
        from repro_torch.kernels.flash_attention.ops import flash_attention
        if not q.is_cuda:
            raise ValueError(f"impl='cuda' needs CUDA tensors, got {q.device}")
        out = flash_attention(q, k, v, causal=causal, window=window)
    else:
        rep = cfg.n_heads // cfg.n_kv_heads
        if rep > 1:
            k = k.repeat_interleave(rep, 1)
            v = v.repeat_interleave(rep, 1)
        core = _naive_attention if impl == "naive" else _chunked_attention
        # independent along (batch, head): on a mesh, each rank's shards
        out = shd.local_map(lambda q, k, v: core(q, k, v, causal, window),
                            (q, k, v), [(0, 1)] * 3, (0, 1))
    out = shd.constrain(_merge_heads(out), "attn_out")
    return dense(params["wo"], out), None


def init_kv_cache(cfg, batch: int, max_len: int, n_layers: int,
                  dtype=torch.bfloat16, device=None):
    hd = cfg.head_dim
    shape = (n_layers, batch, cfg.n_kv_heads, max_len, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
