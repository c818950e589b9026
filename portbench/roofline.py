"""The benchmark's frozen roofline arithmetic: the H100's data-sheet
peaks, the least time of the flash-attention and SSD kernels at a shape
(copied from `chip_smoke.py`, where PRs 23-28 measured against it), and
the operations and bytes of a whole model step computed from shapes,
which each family counts in its own file, `arithmetic/<family>.py`.

Everything here counts what the computation needs, not what a kernel
happens to do: each input byte read once and each output byte written
once, and the operations of the work these inputs require (a causal
mask's kept pairs, the two chosen experts of a token, the KV positions
already written).
"""
from __future__ import annotations

import functools
from types import SimpleNamespace

from portbench.harness import load

#: H100 SXM data-sheet peaks: HBM bytes/s and dense bf16 tensor-core
#: operations/s (NVIDIA's data sheet, no sparsity, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
BF16 = 2                    # bytes of a bf16 element
F32 = 4


def bound(nbytes: float, ops: float, ops_per_s: float = BF16_OPS_PER_S
          ) -> tuple[float, str]:
    """Least ms for `nbytes` moved once and `ops` at `ops_per_s`, and
    which of the two bounds it."""
    by = nbytes / HBM_BYTES_PER_S * 1e3
    op = ops / ops_per_s * 1e3
    return (by, "bytes") if by >= op else (op, "operations")


def causal_pairs(lq: int, lk: int, window: int | None = None) -> int:
    """(query, key) pairs a causal mask keeps, queries aligned to the end
    of the keys; with a window, only keys less than `window` behind."""
    pairs = 0
    for i in range(lq):
        last = lk - lq + i                   # the row's newest key
        if last < 0:
            continue
        first = 0 if window is None else max(0, last - window + 1)
        pairs += last - first + 1
    return pairs


def flash_ops(b, h, lq, lk, d, window=None) -> float:
    """The QK and PV products of the (q, k) pairs the causal mask keeps
    (2 D operations each for QK^T and for PV)."""
    return 4 * d * causal_pairs(lq, lk, window) * b * h


def flash_bound_ms(b, h, lq, lk, d, itemsize=BF16, hkv=None,
                   window=None) -> tuple[float, str]:
    """q, k, v read once and o written once (k and v at `hkv` heads, h by
    default), against `flash_ops` on the bf16 tensor cores."""
    hkv = h if hkv is None else hkv
    return bound(b * (2 * h * lq + 2 * hkv * lk) * d * itemsize,
                 flash_ops(b, h, lq, lk, d, window))


def ssd_ops(b, l, h, p, n, chunk=128, groups=1) -> float:
    """The dual form's products at the reference's chunk (per chunk and
    head: C B^T 2Q^2N, the masked-decay product 2Q^2P, C S^T and the
    state update 2QPN each). C B^T counts once a head, as the kernel
    table's bounds count it, whichever of the `groups` the head's B and
    C come from: the groups change the bytes, not this count."""
    if h % groups:
        raise ValueError(f"{h} heads do not split into {groups} groups")
    nc = -(-l // chunk)
    return b * h * nc * (2 * chunk * chunk * (n + p) + 4 * chunk * p * n)


def ssd_bound_ms(b, l, h, p, n, itemsize=BF16, groups=1
                 ) -> tuple[float, str]:
    """x read and y written once, dt, B and C (b, l, groups, n), a, d
    read once, against `ssd_ops` on the bf16 tensor cores."""
    nbytes = 2 * b * l * h * p * itemsize + b * l * h * F32 \
        + 2 * b * l * groups * n * itemsize + 2 * h * F32
    return bound(nbytes, ssd_ops(b, l, h, p, n, groups=groups))


# --------------------------------------------------------------------------
# whole model steps: each family's counts are in its own file
# --------------------------------------------------------------------------

def attn_weights(cfg) -> int:
    """Elements of one attention block's projections."""
    hd = cfg.head_dim
    return cfg.d_model * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd \
        + cfg.n_heads * hd * cfg.d_model


def arithmetic(cfg, find=None):
    """The whole-step counts of `cfg`'s family,
    `portbench/arithmetic/<family>.py`, which `find` loads (a `Bench`'s
    `module`, which looks under its root first; by default the file
    beside the harness)."""
    try:
        return (find or load)("arithmetic", cfg.family)
    except FileNotFoundError:
        raise ValueError(f"{cfg.name}: no step arithmetic for the family "
                         f"{cfg.family!r} (portbench/arithmetic/"
                         f"{cfg.family}.py)") from None


def layer_macs_per_token(cfg, find=None) -> int:
    """Multiply-adds of the weights one token uses in one layer block,
    without the LM head."""
    return arithmetic(cfg, find).layer_macs_per_token(cfg)


def prefill_flops(cfg, b: int, l: int, find=None) -> float:
    """Operations of one batch prefill of `b` prompts of `l` tokens that
    returns the last token's logits."""
    return arithmetic(cfg, find).prefill_flops(cfg, b, l)


def weight_bytes(cfg, find=None) -> float:
    """Bytes of every weight a decode step reads once."""
    return arithmetic(cfg, find).weight_bytes(cfg)


def decode_step_bound_ms(cfg, b: int, pos: int, find=None
                         ) -> tuple[float, str]:
    """Least ms of one decode step of `b` tokens at position `pos`."""
    return arithmetic(cfg, find).decode_step_bound_ms(cfg, b, pos)


STEPS = ("layer_macs_per_token", "prefill_flops", "weight_bytes",
         "decode_step_bound_ms")


def at(find) -> SimpleNamespace:
    """This module's names, its whole-step counts taken from the family
    files `find` loads: the `roofline` a metric reads in a benchmark
    root."""
    names = {k: v for k, v in globals().items() if not k.startswith("_")}
    for name in STEPS:
        names[name] = functools.partial(names[name], find=find)
    return SimpleNamespace(**names)
