"""Model assembly for the families the port runs: `dense`, `ssm` and
`hybrid` (Zamba2: groups of `attn_every` Mamba2 layers, each followed by
one weight-shared attention block), as `repro.models.transformer` has
them.

  * init_params(cfg, gen, dtype, device) — seeded random weights;
  * forward(cfg, params, batch, impl)   — teacher-forced hidden states;
  * logits_from_hidden                  — the LM head;
  * init_cache / decode_step            — one-token serving with caches,
                                          updated in place.

Parameters are the reference's pytree as plain dicts of tensors, with
per-layer weights stacked on a leading layer axis. `moe`, `audio` and
`vlm` (with its vision stub) are not ported yet and raise
NotImplementedError when a model is built.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.attention import (attention_apply, attention_init,
                                          check_impl)
from repro_torch.models.ssm import init_ssm_state, ssm_apply, ssm_init

FAMILIES = ("dense", "ssm", "hybrid")


def check_family(cfg) -> None:
    if cfg.family not in FAMILIES or cfg.n_experts > 0 or cfg.frontend:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; the port "
            f"runs {FAMILIES} without experts or frontends")


def layer(tree, i: int):
    """Layer i's parameters out of a stacked tree."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


# --------------------------------------------------------------------------
# per-layer blocks
# --------------------------------------------------------------------------

def _block_init(gen, cfg, dtype, device, lead):
    ninit, _ = L.make_norm(cfg.norm)
    kw = dict(dtype=dtype, device=device, lead=lead)
    if cfg.family in ("ssm", "hybrid"):     # hybrid: SSM backbone layers
        return {"norm": ninit(cfg.d_model, **kw),
                "ssm": ssm_init(gen, cfg, **kw)}
    return {"norm1": ninit(cfg.d_model, **kw),
            "attn": attention_init(gen, cfg, **kw),
            "norm2": ninit(cfg.d_model, **kw),
            "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp, **kw)}


def _block_apply(params, x, cfg, positions, impl, causal=True):
    _, norm = L.make_norm(cfg.norm)
    if cfg.family in ("ssm", "hybrid"):
        h, _ = ssm_apply(params["ssm"], norm(params["norm"], x), cfg,
                         impl="chunked" if impl == "naive" else impl)
        return x + h
    a, _ = attention_apply(params["attn"], norm(params["norm1"], x), cfg,
                           positions, causal=causal, impl=impl)
    x = x + a
    return x + L.mlp_apply(params["mlp"], norm(params["norm2"], x), cfg.mlp)


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
    x = x + L.mlp_apply(params["mlp"], norm(params["norm2"], x), cfg.mlp)
    return x, new_cache


# --------------------------------------------------------------------------
# parameter init
# --------------------------------------------------------------------------

def init_params(cfg, gen=0, dtype=torch.bfloat16, device=None):
    """Random weights drawn from `gen`, a `torch.Generator` on `device`
    or an int seed for one. `device=None` is the card."""
    check_family(cfg)
    dev = resolve_device(device)
    if not isinstance(gen, torch.Generator):
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
    return params


# --------------------------------------------------------------------------
# forward (teacher-forced)
# --------------------------------------------------------------------------

def forward(cfg, params, batch, impl="chunked"):
    """batch["tokens"]: (B, S) integer tensor on the parameters' device.
    Returns the final hidden states (B, S, d_model)."""
    check_family(cfg)
    check_impl(impl)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = L.embed(params["embed"], tokens)
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    _, norm = L.make_norm(cfg.norm)
    per_group = cfg.attn_every if cfg.family == "hybrid" else cfg.n_layers
    for li in range(cfg.n_layers):
        x = _block_apply(layer(params["layers"], li), x, cfg, positions,
                         impl)
        if cfg.family == "hybrid" and (li + 1) % per_group == 0:
            a, _ = attention_apply(
                params["shared_attn"], norm(params["shared_norm"], x), cfg,
                positions, causal=True, impl=impl)
            x = x + a
    return norm(params["final_norm"], x)


def logits_from_hidden(cfg, params, hidden):
    return hidden @ params["lm_head"]["w"]


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
    else:
        length = max_len if cfg.sliding_window is None else \
            min(max_len, cfg.sliding_window)
        cache["kv"] = kv(cfg.n_layers, length, cfg.n_kv_heads)
    return cache


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
    else:
        for li in range(cfg.n_layers):
            x, _ = _block_decode(layer(params["layers"], li), x, cfg,
                                 layer(cache["kv"], li), index)
    x = norm(params["final_norm"], x)
    return logits_from_hidden(cfg, params, x)[:, 0], cache
