"""The steps, made as `repro.launch.steps` makes them: the train step
(gradients of the chunked CE through the plain attention and SSD paths,
with micro-batch accumulation and the configured optimizer), the eval
step, the batch prefill step (a forward over whole prompts, which runs
the kernels with impl='cuda') and the one-token decode step (which runs
the cache path).

PyTorch runs eagerly, so a step is a plain function; nothing is jitted.
The dry-run's stand-ins (`input_specs`, `params_spec`, `cache_spec`,
`opt_state_spec`, `step_for_shape`) are tensors on the `meta` device:
shapes and dtypes, no storage, so arctic-480b's ~0.96 TB of weights
cost nothing. `launch.dryrun` places them on a mesh and runs the step
on them.
"""
from __future__ import annotations

import torch

from repro_torch.launch import sharding as shd
from repro_torch.models import transformer as T
from repro_torch.models.loss import chunked_ce
from repro_torch.obs.tracing import STEP_TRACER, step_span
from repro_torch.optim import get_optimizer
from repro_torch.optim.grad_compress import compress_decompress
from repro_torch.tree import leaves, tree_map, unflatten

META = torch.device("meta")
N_PATCHES = 256          # vision stub: prefix patch embeddings


# --------------------------------------------------------------------------
# input specs (meta tensors; no allocation)
# --------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg, shape) -> dict:
    """Model inputs for one step of the given kind."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        batch = {"tokens": _meta((b, s), i32)}
        if shape.kind == "train":
            batch["labels"] = _meta((b, s), i32)
        if cfg.frontend == "vision":
            batch["patch_embeds"] = _meta((b, N_PATCHES, cfg.d_model),
                                          torch.bfloat16)
        if cfg.family == "audio":
            batch["frames"] = _meta((b, cfg.encoder_frames, cfg.d_model),
                                    torch.bfloat16)
        return batch
    # decode: one new token against a KV/state cache of length s
    return {"tokens": _meta((b, 1), i32), "cache_index": _meta((), i32)}


def params_spec(cfg) -> dict:
    """Parameter shapes and dtypes on `meta` (no allocation)."""
    return T.init_params(cfg, device=META)


def cache_spec(cfg, shape) -> dict:
    spec = T.init_cache(cfg, shape.global_batch, shape.seq_len, device=META)
    if cfg.family == "audio":
        # cross K/V primed from a (B, frames, d) encode
        frames = _meta((shape.global_batch, cfg.encoder_frames,
                        cfg.d_model), torch.bfloat16)
        with torch.no_grad():
            spec["cross"] = T.prime_cross_cache(cfg, params_spec(cfg),
                                                {"frames": frames})
    return spec


def opt_state_spec(cfg) -> dict:
    return get_optimizer(cfg.optimizer).init(params_spec(cfg))


def default_microbatches(cfg, shape, n_data: int,
                         budget_bytes: float = 6e9) -> int:
    """Gradient-accumulation factor sized so the remat-saved per-layer
    residuals (n_layers x B_dev x S x d x 2 bytes) fit the activation
    budget; MoE keeps 0.6 of it for its dispatch transients."""
    b_dev = max(shape.global_batch // n_data, 1)
    resid = cfg.n_layers * b_dev * shape.seq_len * cfg.d_model * 2
    if cfg.n_experts > 0:
        budget_bytes *= 0.6
    micro = 1
    while resid / micro > budget_bytes and micro < b_dev:
        micro *= 2
    return micro


def loss_and_grads(cfg, params, batch, impl: str = "chunked"):
    """(loss, grads): the chunked CE of `forward` on `batch` and its
    gradient with respect to every parameter, a tree like `params` in
    the parameters' dtypes. The parameters themselves are left as they
    were."""
    flat = leaves(params)
    with torch.enable_grad():
        xs = [t.detach().requires_grad_() for t in flat]
        # on a mesh, each gradient in its parameter's layout
        p = unflatten(params, [shd.grad_like(x) for x in xs])
        hidden = T.forward(cfg, p, batch, impl=impl)
        loss = chunked_ce(hidden, p["lm_head"]["w"], batch["labels"])
        grads = torch.autograd.grad(loss, xs)
    return loss.detach(), unflatten(params, grads)


def make_train_step(cfg, impl: str = "chunked", lr: float = 3e-4,
                    grad_compression: bool = False, microbatches: int = 1,
                    donate: bool = False):
    """(params, opt_state, batch) -> (params, opt_state, metrics), with
    metrics {"loss", "grad_norm"} as float32 tensors.

    microbatches > 1 splits the batch's dim 0 into that many contiguous
    slices, accumulates their gradients in `cfg.grad_accum_dtype` in slice
    order and divides by the count. `donate=True` lets the optimizer
    write the new parameters and state into the old tensors (the
    reference's launchers jit the step with `donate_argnums`); the default
    returns new tensors and leaves the inputs as they were."""
    opt = get_optimizer(cfg.optimizer)
    acc_dtype = getattr(torch, cfg.grad_accum_dtype)

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, grads = loss_and_grads(cfg, params, batch, impl)
        else:
            n = next(iter(batch.values())).shape[0] // microbatches
            count = torch.full((), microbatches, dtype=acc_dtype,
                               device=leaves(params)[0].device)
            gsum = tree_map(lambda p: torch.zeros_like(p, dtype=acc_dtype),
                            params)
            lsum = torch.zeros((), dtype=torch.float32, device=count.device)
            for i in range(microbatches):
                # on a mesh, each micro-batch split as the batch is
                mb = {k: shd.like(v[i * n:(i + 1) * n], v)
                      for k, v in batch.items()}
                loss, g = loss_and_grads(cfg, params, mb, impl)
                gsum = tree_map(lambda a, b: a + b.to(acc_dtype), gsum, g)
                lsum = lsum + loss
                del g
            grads = tree_map(lambda g: g / count, gsum)
            loss = lsum / count.float()
            del gsum
        if grad_compression:
            grads = compress_decompress(grads)
        params, opt_state, gnorm = opt.update(grads, opt_state, params, lr,
                                              donate=donate)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def make_eval_step(cfg, impl: str = "chunked"):
    """(params, batch) -> the chunked CE of the batch, float32."""
    @torch.no_grad()
    def eval_step(params, batch):
        hidden = T.forward(cfg, params, batch, impl=impl)
        return chunked_ce(hidden, params["lm_head"]["w"], batch["labels"])
    return eval_step


def make_prefill_step(cfg, impl: str = "chunked", tracer=STEP_TRACER):
    """(params, batch) -> last-token logits (B, vocab). The batch goes to
    `forward` whole: "tokens", and "frames" (audio) or "patch_embeds"
    (vlm) where the family reads them. Each call is a batch of `tracer`
    (an `obs.tracing.StepTracer`; None records nothing): a root span
    "prefill_step" with count `tokens` = B*L, the spans the model opens
    under it (`transformer.forward`), and "lm_head", the head on the
    last positions (the final norm is `forward`'s, in the root's own
    time)."""
    def prefill_step(params, batch):
        if tracer is None:
            return _prefill(cfg, params, batch, impl)
        tokens = batch["tokens"]
        with tracer.span("prefill_step", device=tokens.device,
                         tokens=tokens.numel()):
            return _prefill(cfg, params, batch, impl)
    return prefill_step


def _prefill(cfg, params, batch, impl):
    hidden = T.forward(cfg, params, batch, impl=impl)
    with step_span("lm_head"):
        return T.logits_from_hidden(cfg, params, hidden[:, -1:])[:, 0]


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
    """The reference's vocab-blocked argmax: constraining the block axis
    to 'model' keeps the inner argmax local to each vocab shard, and only
    the (B, n_blocks) maxima cross shards. On one card it equals
    `argmax`: the first maximum of the first block holding the
    maximum."""
    b, v = logits.shape
    if v % n_blocks:
        return logits.argmax(-1).to(torch.int32)
    lb = logits.reshape(b, n_blocks, v // n_blocks)
    lb = shd.constrain(lb, "logits_blocks")
    loc_max, loc_arg = lb.max(-1)
    # the (B, n_blocks) maxima are what crosses the shards
    loc_max = shd.replicate(loc_max, dims=(1,))
    loc_arg = shd.replicate(loc_arg, dims=(1,))
    blk = loc_max.argmax(-1)
    inner = loc_arg.gather(1, blk[:, None])[:, 0]
    return (blk * (v // n_blocks) + inner).to(torch.int32)


def step_for_shape(cfg, shape, impl: str = "chunked", n_data: int = 16,
                   microbatches: int | None = None):
    """(step, args, names): the dry-run cell's step and its meta
    arguments, named "params", "opt_state", "cache" or "batch"."""
    if shape.kind == "train":
        if microbatches is None:
            microbatches = default_microbatches(cfg, shape, n_data)
        step = make_train_step(cfg, impl=impl, microbatches=microbatches)
        args = (params_spec(cfg), opt_state_spec(cfg),
                input_specs(cfg, shape))
        return step, args, ("params", "opt_state", "batch")
    if shape.kind == "prefill":
        step = make_prefill_step(cfg, impl=impl, tracer=None)
        args = (params_spec(cfg), input_specs(cfg, shape))
        return step, args, ("params", "batch")
    step = make_serve_step(cfg, return_logits=False)
    args = (params_spec(cfg), cache_spec(cfg, shape),
            input_specs(cfg, shape))
    return step, args, ("params", "cache", "batch")
