"""Model assembly for the ten configurations, as
`repro.models.transformer` has them: the `dense`, `moe` and `vlm`
families (qwen2-vl's vision frontend a stub: precomputed patch
embeddings overwrite the first positions), `ssm`, `hybrid` (Zamba2:
groups of `attn_every` Mamba2 layers, each followed by one weight-shared
attention block) and `audio` (whisper: an encoder over precomputed
frames, a decoder with self- and cross-attention).

  * init_params(cfg, gen, dtype, device) — seeded random weights;
  * forward(cfg, params, batch, impl)   — teacher-forced hidden states,
                                          each block under activation
                                          checkpointing when `cfg.remat`
                                          is set and its parameters
                                          require grad (training);
  * logits_from_hidden                  — the LM head;
  * init_cache / prime_cross_cache / decode_step
                                        — one-token serving with caches,
                                          updated in place.

Parameters are the reference's pytree as plain dicts of tensors, with
per-layer weights stacked on a leading layer axis.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.launch import sharding as shd
from repro_torch.models import layers as L
from repro_torch.models.attention import (attention_apply, attention_init,
                                          check_impl)
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.models.ssm import init_ssm_state, ssm_apply, ssm_init
from repro_torch.tree import leaves

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}, not "
                         f"one of {FAMILIES}")


def layer(tree, i: int):
    """Layer i's parameters out of a stacked tree."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


def unstack(tree, n: int) -> list:
    """The n layers' parameters out of a stacked tree, one `unbind` a
    leaf: its backward stacks the layers' gradients once, where taking a
    layer at a time would add a zero-filled gradient the size of the
    whole stack for every layer. On a mesh each layer's gradient is laid
    out as its parameter as soon as it is computed (`shd.grad_like`)."""
    if isinstance(tree, dict):
        kids = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in kids.items()} for i in range(n)]
    return [shd.grad_like(t) for t in tree.unbind(0)]


def _remat(cfg, fn, x, lp):
    """fn(x), under activation checkpointing (the reference's
    `jax.checkpoint` of each scanned layer) when `cfg.remat` is set and
    the layer's parameters `lp` require grad: the backward recomputes the
    layer from x. Serving's parameters never require grad."""
    if cfg.remat and torch.is_grad_enabled() \
            and any(t.requires_grad for t in leaves(lp)):
        return checkpoint(fn, x, use_reentrant=False)
    return fn(x)


# --------------------------------------------------------------------------
# per-layer blocks
# --------------------------------------------------------------------------

def _block_init(gen, cfg, dtype, device, lead):
    ninit, _ = L.make_norm(cfg.norm)
    kw = dict(dtype=dtype, device=device, lead=lead)
    if cfg.family in ("ssm", "hybrid"):     # hybrid: SSM backbone layers
        return {"norm": ninit(cfg.d_model, **kw),
                "ssm": ssm_init(gen, cfg, **kw)}
    p = {"norm1": ninit(cfg.d_model, **kw),
         "attn": attention_init(gen, cfg, **kw),
         "norm2": ninit(cfg.d_model, **kw)}
    if cfg.n_experts > 0:
        p["moe"] = moe_init(gen, cfg, **kw)
    else:
        p["mlp"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp, **kw)
    return p


def _ffn(params, x, cfg, capacity_factor):
    """The block's feed-forward half on the normed input x."""
    if cfg.n_experts > 0:
        return moe_apply(params["moe"], x, cfg, capacity_factor)
    return L.mlp_apply(params["mlp"], x, cfg.mlp)


def _block_apply(params, x, cfg, positions, impl, causal=True):
    _, norm = L.make_norm(cfg.norm)
    if cfg.family in ("ssm", "hybrid"):
        h, _ = ssm_apply(params["ssm"], norm(params["norm"], x), cfg,
                         impl="chunked" if impl == "naive" else impl)
        return x + h
    a, _ = attention_apply(params["attn"], norm(params["norm1"], x), cfg,
                           positions, causal=causal, impl=impl)
    x = x + a
    x = x + _ffn(params, norm(params["norm2"], x), cfg, 1.25)
    return shd.constrain(x, "residual")


def _block_decode(params, x, cfg, cache, index):
    _, norm = L.make_norm(cfg.norm)
    if cfg.family in ("ssm", "hybrid"):
        h, new_state = ssm_apply(params["ssm"], norm(params["norm"], x),
                                 cfg, state=cache)
        return x + h, new_state
    a, new_cache = attention_apply(
        params["attn"], norm(params["norm1"], x), cfg, None,
        kv_cache=cache, cache_index=index)
    x = x + a
    # dropless MoE in decode: serving logits must be exact
    return x + _ffn(params, norm(params["norm2"], x), cfg, None), new_cache


# --------------------------------------------------------------------------
# parameter init
# --------------------------------------------------------------------------

def init_params(cfg, gen=0, dtype=torch.bfloat16, device=None):
    """Random weights drawn from `gen`, a `torch.Generator` on `device`
    or an int seed for one. `device=None` is the card; on `meta` the
    tree has the shapes and dtypes and nothing is allocated or drawn."""
    check_family(cfg)
    dev = resolve_device(device)
    if dev.type == "meta":
        gen = None
    elif not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(gen))
    ninit, _ = L.make_norm(cfg.norm)
    params = {
        "embed": L.embedding_init(gen, cfg.vocab_size, cfg.d_model, dtype,
                                  dev),
        "layers": _block_init(gen, cfg, dtype, dev, (cfg.n_layers,)),
        "final_norm": ninit(cfg.d_model, dtype, dev),
        "lm_head": L.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                dtype=dtype, device=dev),
    }
    if cfg.family == "hybrid":
        params["shared_attn"] = attention_init(gen, cfg, dtype, dev)
        params["shared_norm"] = ninit(cfg.d_model, dtype, dev)
    if cfg.family == "audio":
        params["enc_layers"] = _block_init(gen, cfg.encoder_cfg(), dtype, dev,
                                           (cfg.encoder_layers,))
        params["enc_norm"] = ninit(cfg.d_model, dtype, dev)
        lead = (cfg.n_layers,)
        params["cross_layers"] = {
            "norm": ninit(cfg.d_model, dtype, dev, lead),
            "attn": attention_init(gen, cfg, dtype, dev, lead)}
    return params


# --------------------------------------------------------------------------
# forward (teacher-forced)
# --------------------------------------------------------------------------

def forward(cfg, params, batch, impl="chunked"):
    """batch["tokens"]: (B, S) integer tensor on the parameters' device;
    for `vlm` optionally batch["patch_embeds"] (B, P, d), which overwrite
    the first P positions; for `audio` batch["frames"] (B, F, d), the
    encoder's input. Returns the final hidden states (B, S, d_model)."""
    check_family(cfg)
    check_impl(impl)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = L.embed(params["embed"], tokens)
    if cfg.frontend == "vision" and "patch_embeds" in batch:
        pe = batch["patch_embeds"]
        if pe.shape[1] > s:
            raise ValueError(f"{pe.shape[1]} patch embeddings for {s} "
                             "positions")
        # out of place, as the reference's dynamic_update_slice
        x = torch.cat([pe.to(x.dtype), x[:, pe.shape[1]:]], dim=1)
    x = shd.constrain(x, "residual")
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    if cfg.family == "audio":
        enc = _encode(cfg, params, batch)
        return _decode_stack_ed(cfg, params, x, positions, enc, impl)
    _, norm = L.make_norm(cfg.norm)
    per_group = cfg.attn_every if cfg.family == "hybrid" else cfg.n_layers
    for li, lp in enumerate(unstack(params["layers"], cfg.n_layers)):
        x = _remat(cfg, lambda h, lp=lp: _block_apply(lp, h, cfg, positions,
                                                      impl), x, lp)
        if cfg.family == "hybrid" and (li + 1) % per_group == 0:
            a, _ = attention_apply(
                params["shared_attn"], norm(params["shared_norm"], x), cfg,
                positions, causal=True, impl=impl)
            x = x + a
    return norm(params["final_norm"], x)


def _encode(cfg, params, batch):
    """Whisper's encoder over precomputed conv-frontend frames (B, F, d).
    Its attention is non-causal and always 'chunked', whatever the
    decoder's impl: the reference hard-codes its plain path here."""
    frames = batch["frames"]
    b, f, _ = frames.shape
    pos_tab = L.sinusoidal_positions(f, cfg.d_model, frames.device)
    x = frames + pos_tab[None].to(frames.dtype)
    enc_cfg = cfg.encoder_cfg()
    positions = torch.arange(f, device=x.device)[None].expand(b, f)
    for lp in unstack(params["enc_layers"], cfg.encoder_layers):
        x = _remat(cfg, lambda h, lp=lp: _block_apply(
            lp, h, enc_cfg, positions, "chunked", causal=False), x, lp)
    _, norm = L.make_norm(cfg.norm)
    return norm(params["enc_norm"], x)


def _decode_stack_ed(cfg, params, x, positions, enc, impl):
    """Whisper's decoder: self-attention, cross-attention over `enc`,
    MLP."""
    _, norm = L.make_norm(cfg.norm)

    def dec_layer(h, blk, cross):
        a, _ = attention_apply(blk["attn"], norm(blk["norm1"], h), cfg,
                               positions, causal=True, impl=impl)
        h = h + a
        c, _ = attention_apply(cross["attn"], norm(cross["norm"], h), cfg,
                               None, causal=False, impl=impl, x_kv=enc)
        h = h + c
        return h + L.mlp_apply(blk["mlp"], norm(blk["norm2"], h), cfg.mlp)

    for blk, cross in zip(unstack(params["layers"], cfg.n_layers),
                          unstack(params["cross_layers"], cfg.n_layers)):
        x = _remat(cfg, lambda h, b=blk, c=cross: dec_layer(h, b, c), x,
                   (blk, cross))
    return norm(params["final_norm"], x)


def logits_from_hidden(cfg, params, hidden):
    return shd.constrain(hidden @ shd.fsdp_weight(params["lm_head"]["w"]),
                         "logits")


# --------------------------------------------------------------------------
# decode (serving)
# --------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None):
    """Cache for one-token decode at kv length `max_len`. The KV cache is
    bf16 by default even for float32 parameters, as in the reference; the
    SSM state is float32. `device=None` is the card."""
    check_family(cfg)
    dev = resolve_device(device)
    hd = cfg.head_dim

    def kv(n_layers, length, heads):
        shape = (n_layers, batch, heads, length, hd)
        c = {"k": torch.zeros(shape, dtype=dtype, device=dev),
             "v": torch.zeros(shape, dtype=dtype, device=dev)}
        if cfg.sliding_window is not None and length >= cfg.sliding_window:
            c["pos"] = torch.full((n_layers, length), -1, dtype=torch.int32,
                                  device=dev)
        return c

    cache = {}
    if cfg.family == "ssm":
        cache["ssm"] = init_ssm_state(cfg, batch, cfg.n_layers, device=dev)
    elif cfg.family == "hybrid":
        groups = cfg.n_layers // cfg.attn_every
        cache["ssm"] = init_ssm_state(cfg, batch, cfg.n_layers, device=dev)
        cache["shared_kv"] = kv(groups, max_len, cfg.n_kv_heads)
    elif cfg.family == "audio":
        cache["kv"] = kv(cfg.n_layers, max_len, cfg.n_kv_heads)
        cache["cross"] = None        # filled by prime_cross_cache
    else:
        length = max_len if cfg.sliding_window is None else \
            min(max_len, cfg.sliding_window)
        cache["kv"] = kv(cfg.n_layers, length, cfg.n_kv_heads)
    return cache


def prime_cross_cache(cfg, params, batch_inputs):
    """Whisper: run the encoder once over batch_inputs["frames"] and
    return each decoder layer's cross keys and values, {"k", "v"} of
    (n_layers, B, Hkv, F, hd), for `cache["cross"]`."""
    enc = _encode(cfg, params, batch_inputs)        # (B, F, d)
    b, f, _ = enc.shape
    out = {"k": [], "v": []}
    for li in range(cfg.n_layers):
        attn = layer(params["cross_layers"], li)["attn"]
        for name, w in (("k", "wk"), ("v", "wv")):
            out[name].append(L.dense(attn[w], enc).reshape(
                b, f, cfg.n_kv_heads, cfg.head_dim).transpose(1, 2))
    return {name: torch.stack(ts) for name, ts in out.items()}


def decode_step(cfg, params, cache, tokens, index: int, impl="naive"):
    """tokens: (B, 1) integer tensor; index: the token's position (int).
    Advances `cache` in place and returns (logits (B, vocab), cache).
    `impl` is accepted for the reference's signature; decode attends the
    cache directly whatever it is."""
    check_family(cfg)
    check_impl(impl)
    index = int(index)
    x = L.embed(params["embed"], tokens)
    _, norm = L.make_norm(cfg.norm)
    if cfg.family in ("ssm", "hybrid"):
        st = cache["ssm"]
        for li in range(cfg.n_layers):
            x, new = _block_decode(layer(params["layers"], li), x, cfg,
                                   layer(st, li), index)
            st["conv"][li] = new["conv"]
            st["ssm"][li] = new["ssm"]
            if cfg.family == "hybrid" and (li + 1) % cfg.attn_every == 0:
                g = (li + 1) // cfg.attn_every - 1
                a, _ = attention_apply(
                    params["shared_attn"], norm(params["shared_norm"], x),
                    cfg, None, kv_cache=layer(cache["shared_kv"], g),
                    cache_index=index)
                x = x + a
    elif cfg.family == "audio":
        for li in range(cfg.n_layers):
            lp = layer(params["layers"], li)
            cross = layer(params["cross_layers"], li)
            a, _ = attention_apply(lp["attn"], norm(lp["norm1"], x), cfg,
                                   None, kv_cache=layer(cache["kv"], li),
                                   cache_index=index)
            x = x + a
            # cross-attention over the primed encoder K/V (never updated)
            x = x + _cross_decode(cfg, cross, norm(cross["norm"], x),
                                  layer(cache["cross"], li))
            x = x + L.mlp_apply(lp["mlp"], norm(lp["norm2"], x), cfg.mlp)
    else:
        for li in range(cfg.n_layers):
            x, _ = _block_decode(layer(params["layers"], li), x, cfg,
                                 layer(cache["kv"], li), index)
    x = norm(params["final_norm"], x)
    return logits_from_hidden(cfg, params, x)[:, 0], cache


def _cross_decode(cfg, cross_lp, x, cross_kv):
    """Single-query cross-attention of x: (B, 1, d) against the fixed
    encoder keys and values of one layer ((B, Hkv, F, hd) each)."""
    hd = cfg.head_dim
    b = x.shape[0]
    q = shd.splittable(L.dense(cross_lp["attn"]["wq"], x), -1,
                       cfg.n_heads).reshape(b, 1, cfg.n_heads, hd) \
        .transpose(1, 2)
    rep = cfg.n_heads // cfg.n_kv_heads
    k = cross_kv["k"].repeat_interleave(rep, 1)
    v = cross_kv["v"].repeat_interleave(rep, 1)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * hd ** -0.5
    p = torch.softmax(s, -1).to(q.dtype)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v)
    o = o.transpose(1, 2).reshape(b, 1, cfg.n_heads * hd)
    return L.dense(cross_lp["attn"]["wo"], o)
