"""Serving step builders, as `repro.launch.steps` has them: the batch
prefill step (a forward over whole prompts, which runs the kernels with
impl='cuda') and the one-token decode step (which runs the cache path).

PyTorch runs eagerly, so a step is a plain function; nothing is jitted.
The training and evaluation steps and the input, parameter and cache
specs of the dry-run wait for the training slice.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as T


def make_prefill_step(cfg, impl: str = "chunked"):
    """(params, batch) -> last-token logits (B, vocab). The batch goes to
    `forward` whole: "tokens", and "frames" (audio) or "patch_embeds"
    (vlm) where the family reads them."""
    def prefill_step(params, batch):
        hidden = T.forward(cfg, params, batch, impl=impl)
        return T.logits_from_hidden(cfg, params, hidden[:, -1:])[:, 0]
    return prefill_step


def make_serve_step(cfg, impl: str = "naive", return_logits: bool = True):
    """One-token decode: (params, cache, batch) -> (out, cache), with
    batch = {"tokens": (B, 1), "cache_index": int}. The cache advances in
    place. return_logits=False returns greedy token ids (B,) instead."""
    def serve_step(params, cache, batch):
        logits, cache = T.decode_step(cfg, params, cache, batch["tokens"],
                                      batch["cache_index"], impl=impl)
        if return_logits:
            return logits, cache
        return _sharded_greedy(cfg, logits), cache
    return serve_step


def _sharded_greedy(cfg, logits, n_blocks: int = 16):
    """The reference's vocab-blocked argmax (it keeps the argmax local to
    each vocab shard on a mesh). On one card it equals `argmax`: the
    first maximum of the first block holding the maximum."""
    b, v = logits.shape
    if v % n_blocks:
        return logits.argmax(-1).to(torch.int32)
    lb = logits.reshape(b, n_blocks, v // n_blocks)
    loc_max, loc_arg = lb.max(-1)
    blk = loc_max.argmax(-1)
    inner = loc_arg.gather(1, blk[:, None])[:, 0]
    return (blk * (v // n_blocks) + inner).to(torch.int32)
