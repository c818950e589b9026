"""Serving launcher: batched greedy decoding with KV and SSM caches (and
whisper's primed cross-attention cache), as `repro.launch.serve` has it —
the user-facing job that per-VM capping protects. Any of the ten
configurations.

Usage (on the card unless --device says otherwise):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \
      --reduced --requests 8 --prompt-len 16 --gen 32 [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import transformer as T


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_batch(cfg, params, prompts: np.ndarray, gen_tokens: int,
                impl: str = "naive", trace: dict | None = None):
    """Greedy-decode `gen_tokens` for a batch of same-length prompts on
    the parameters' device. The prompts go in token by token through the
    decode path (batch prefill through `forward` is the other serving
    entry point, `steps.make_prefill_step`). Returns (B, gen_tokens)
    int tokens.

    `trace`, when a dict, receives `prompt_logits` (the logits after the
    last prompt token, (B, vocab)) and the seconds of the prompt and of
    the generation phases, `prompt_s` and `gen_s`."""
    dev = params["embed"]["w"].device
    b, prompt_len = prompts.shape
    cache = T.init_cache(cfg, b, prompt_len + gen_tokens, device=dev)
    if cfg.family == "audio":
        # the reference's stand-in audio: zero frames through the encoder
        frames = torch.zeros((b, cfg.encoder_frames, cfg.d_model),
                             dtype=torch.bfloat16, device=dev)
        cache["cross"] = T.prime_cross_cache(cfg, params, {"frames": frames})
    step = make_serve_step(cfg, impl=impl)
    toks = torch.as_tensor(np.asarray(prompts), dtype=torch.long,
                           device=dev)
    t0 = time.perf_counter()
    last = None
    for i in range(prompt_len):
        last, cache = step(params, cache, {"tokens": toks[:, i:i + 1],
                                           "cache_index": i})
    if trace is not None:
        _sync(dev)
        trace["prompt_logits"] = last
        trace["prompt_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
    cur = last.argmax(-1)[:, None]
    out = []
    for i in range(gen_tokens):
        out.append(cur[:, 0])
        last, cache = step(params, cache, {"tokens": cur,
                                           "cache_index": prompt_len + i})
        cur = last.argmax(-1)[:, None]
    tokens = torch.stack(out, 1).cpu().numpy() if out \
        else np.zeros((b, 0), np.int64)
    if trace is not None:
        trace["gen_s"] = time.perf_counter() - t0
    return tokens


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; the card when omitted")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = T.init_params(cfg, args.seed, device=dev)
    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (args.requests, args.prompt_len))
    t0 = time.time()
    tokens = serve_batch(cfg, params, prompts, args.gen)
    dt = time.time() - t0
    total = args.requests * args.gen
    print(f"[serve] {cfg.name} on {dev}: {total} tokens in {dt:.1f}s "
          f"({total / dt:.1f} tok/s), output shape {tokens.shape}")
    return tokens


if __name__ == "__main__":
    main()
