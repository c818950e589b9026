"""The port's LM serving slice against the JAX package on the CPU, on
the same numpy inputs and the same weights (the JAX `init_params` tree
carried across by `repro_torch.convert.lm_params_from_numpy`): layers,
`attention_apply` (prefill and decode, with the rolling cache of reduced
mixtral-8x22b's window, and whisper's cross-attention), `ssm_apply`
(prefill and decode), `forward` and `decode_step` on reduced llama3-8b,
mamba2-2.7b, zamba2-2.7b, mixtral-8x22b, arctic-480b, whisper-tiny and
qwen2-vl-72b, and the slice as a whole (`serve_batch`, the CLI and
`make_prefill_step`).

Tolerances. In float32 the two packages differ only by the order of
float32 sums (matmuls, the chunked scans): ~2e-6 on reduced logits, held
at atol/rtol 1e-4. The decode path keeps the KV cache in bf16 even for
float32 parameters (as the reference does), and a 1e-7 difference can
round a cached value to the next bf16 (2^-8 relative), so decode outputs
are held at 2e-3. In bf16 both round at other places; the reference's
own prefill/decode bar holds: atol 0.15, rtol 0.1
(tests/test_models_smoke.py). A bf16 MoE token whose top-k experts
differ between the packages (a near tie of its router logits) takes
another expert's output and is exempt from that bar (`routing_flips`).
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_config  # noqa: E402
from repro.launch.serve import serve_batch as j_serve_batch  # noqa: E402
from repro.launch.steps import make_prefill_step as j_prefill  # noqa: E402
from repro.launch.steps import _sharded_greedy as j_greedy  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.device import KERNEL_LAUNCHES, reset_launches  # noqa: E402
from repro_torch.launch import serve as PS  # noqa: E402
from repro_torch.launch.steps import (_sharded_greedy,  # noqa: E402
                                      make_prefill_step, make_serve_step)
from repro_torch.models import attention as PA  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import moe as PM  # noqa: E402
from repro_torch.models import ssm as PSM  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402

F32 = dict(atol=1e-4, rtol=1e-4)
F32_DECODE = dict(atol=2e-3, rtol=2e-3)
BF16 = dict(atol=0.15, rtol=0.1)
DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                    torch.bfloat16)}
#: The moe, audio and vlm families (reduced: 4 experts top-2, whisper's
#: 2 + 2 layers over 32 frames, qwen2-vl's M-RoPE with patch embeddings).
FAMILIES = ["mixtral-8x22b", "arctic-480b", "whisper-tiny", "qwen2-vl-72b"]
ARCHS = ["llama3-8b", "mamba2-2.7b", "zamba2-2.7b"] + FAMILIES


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tree(tree, dtype):
    """A JAX param subtree as torch tensors of `dtype` (float32 leaves of
    the reference stay float32)."""
    if isinstance(tree, dict):
        return {k: _tree(v, dtype) for k, v in tree.items()}
    a = np.array(jnp.asarray(tree, jnp.float32))
    t = torch.from_numpy(a)
    return t if tree.dtype == jnp.float32 and dtype == torch.bfloat16 \
        else t.to(dtype)


def _pair(seed, shape, dtype="f32", scale=1.0):
    """The same values in both packages, rounded once to the dtype."""
    jdt, tdt = DT[dtype]
    a = (np.random.default_rng(seed).normal(0, 1, shape) * scale) \
        .astype(np.float32)
    j = jnp.asarray(a).astype(jdt)
    return j, torch.from_numpy(np.array(jnp.asarray(j, jnp.float32))).to(tdt)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


# --- layers ------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_norms_dense_embed(dtype):
    jx, tx = _pair(0, (2, 5, 64), dtype, 3.0)
    js, ts = _pair(1, (64,), dtype)
    jb, tb = _pair(2, (64,), dtype)
    tol = F32 if dtype == "f32" else dict(atol=2e-2, rtol=1e-2)
    _close(PL.rmsnorm({"scale": ts}, tx), JL.rmsnorm({"scale": js}, jx), tol)
    _close(PL.layernorm({"scale": ts, "bias": tb}, tx),
           JL.layernorm({"scale": js, "bias": jb}, jx), tol)
    jw, tw = _pair(3, (64, 24), dtype, 0.1)
    jbb, tbb = _pair(4, (24,), dtype)
    _close(PL.dense({"w": tw, "b": tbb}, tx),
           JL.dense({"w": jw, "b": jbb}, jx), tol)
    ids = np.array([[3, 0, 9], [1, 1, 4]])
    _close(PL.embed({"w": tw.T.contiguous()}, torch.as_tensor(ids)),
           JL.embed({"w": jw.T}, jnp.asarray(ids)), dict(atol=0, rtol=0))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rope_and_mrope(dtype):
    jx, tx = _pair(5, (2, 3, 7, 16), dtype)
    pos = np.random.default_rng(6).integers(0, 500, (2, 7))
    tol = F32 if dtype == "f32" else dict(atol=2e-2, rtol=1e-2)
    _close(PL.apply_rope(tx, torch.as_tensor(pos), 5e5),
           JL.apply_rope(jx, jnp.asarray(pos), 5e5), tol)
    pos3 = np.random.default_rng(7).integers(0, 50, (2, 3, 7))
    _close(PL.apply_mrope(tx, torch.as_tensor(pos3), (4, 2, 2), 1e6),
           JL.apply_mrope(jx, jnp.asarray(pos3), (4, 2, 2), 1e6), tol)


@pytest.mark.parametrize("kind", ["swiglu", "relu2", "gelu"])
def test_mlps(kind):
    jp = JL.mlp_init(jax.random.PRNGKey(8), 32, 64, kind, jnp.float32)
    jx, tx = _pair(9, (2, 5, 32))
    _close(PL.mlp_apply(_tree(jp, torch.float32), tx, kind),
           JL.mlp_apply(jp, jx, kind), F32)


def test_softplus_is_the_reference_function():
    x = np.concatenate([np.linspace(-40, 40, 801), [15.0, 20.0, 25.0]]) \
        .astype(np.float32)
    np.testing.assert_allclose(
        PL.softplus(torch.from_numpy(x)).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=1e-6, atol=0)


# --- attention ---------------------------------------------------------------

def _attn(arch, dtype, seed=10, **over):
    cfg = dataclasses.replace(j_config(arch).reduced(), **over)
    jp = JA.attention_init(jax.random.PRNGKey(seed), cfg, DT[dtype][0])
    return cfg, jp, _tree(jp, DT[dtype][1])


@pytest.mark.parametrize("arch,length", [("llama3-8b", 40),
                                         ("mixtral-8x22b", 96)])
@pytest.mark.parametrize("impl", ["naive", "chunked"])
def test_attention_prefill(arch, length, impl):
    """GQA rep 2 (llama) and the 64-token window (mixtral) over 96."""
    cfg, jp, tp = _attn(arch, "f32")
    jx, tx = _pair(11, (2, length, cfg.d_model))
    pos = np.tile(np.arange(length), (2, 1))
    got, _ = PA.attention_apply(tp, tx, cfg, torch.as_tensor(pos),
                                impl=impl)
    want, _ = JA.attention_apply(
        jp, jx, cfg, jnp.asarray(pos),
        impl="naive" if impl == "naive" else "xla_chunked")
    _close(got, want, F32)


def test_attention_impls_are_checked():
    cfg, _, tp = _attn("llama3-8b", "f32")
    x = torch.zeros(1, 4, cfg.d_model)
    pos = torch.arange(4)[None]
    for impl in ("pallas", "xla_chunked"):
        with pytest.raises(ValueError, match="impl"):
            PA.attention_apply(tp, x, cfg, pos, impl=impl)
    with pytest.raises(ValueError, match="CUDA"):
        PA.attention_apply(tp, x, cfg, pos, impl="cuda")


@pytest.mark.parametrize("arch,cache_len,steps", [
    ("llama3-8b", 24, 20), ("mixtral-8x22b", 64, 80)])
def test_attention_decode_cache(arch, cache_len, steps):
    """Token by token against the cache. Mixtral's cache is the rolling
    window (capacity 64 = window, 80 steps: it wraps), with the `pos`
    buffer deciding validity."""
    cfg, jp, tp = _attn(arch, "f32")
    jc = JA.init_kv_cache(cfg, 2, cache_len, 1)
    jc = {"k": jc["k"][0], "v": jc["v"][0]}
    tc = PA.init_kv_cache(cfg, 2, cache_len, 1)
    tc = {"k": tc["k"][0], "v": tc["v"][0]}
    if cfg.sliding_window is not None:
        jc["pos"] = jnp.full((cache_len,), -1, jnp.int32)
        tc["pos"] = torch.full((cache_len,), -1, dtype=torch.int32)
    jxs, txs = _pair(12, (2, steps, cfg.d_model))
    for i in range(steps):
        want, jc = JA.attention_apply(jp, jxs[:, i:i + 1], cfg, None,
                                      kv_cache=jc, cache_index=i)
        got, tc = PA.attention_apply(tp, txs[:, i:i + 1], cfg, None,
                                     kv_cache=tc, cache_index=i)
        _close(got, want, F32_DECODE)
    _close(tc["k"], jc["k"], F32_DECODE)
    if "pos" in tc:
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


# --- ssm ---------------------------------------------------------------------

def _ssm(dtype, seed=13):
    cfg = j_config("zamba2-2.7b").reduced()
    jp = JS.ssm_init(jax.random.PRNGKey(seed), cfg, DT[dtype][0])
    return cfg, jp, _tree(jp, DT[dtype][1])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("length", [24, 150])
def test_ssm_prefill(dtype, length):
    """The plain chunked SSD against the reference's scan and its Pallas
    kernel in interpret mode (150 steps: two chunks, the second ragged)."""
    cfg, jp, tp = _ssm(dtype)
    jx, tx = _pair(14, (2, length, cfg.d_model), dtype)
    got, _ = PSM.ssm_apply(tp, tx, cfg, impl="chunked")
    assert got.dtype == tx.dtype
    tol = F32 if dtype == "f32" else BF16
    for impl in ("xla_chunked", "pallas"):
        want, _ = JS.ssm_apply(jp, jx, cfg, impl=impl)
        _close(got, want, tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ssm_decode(dtype):
    """The exact one-step recurrence with its float32 {conv, ssm} state,
    10 steps."""
    cfg, jp, tp = _ssm(dtype)
    js = {k: v[0] for k, v in JS.init_ssm_state(cfg, 2, 1).items()}
    ts = {k: v[0] for k, v in PSM.init_ssm_state(cfg, 2, 1).items()}
    jxs, txs = _pair(15, (2, 10, cfg.d_model), dtype)
    tol = F32 if dtype == "f32" else BF16
    for i in range(10):
        want, js = JS.ssm_apply(jp, jxs[:, i:i + 1], cfg, state=js)
        got, ts = PSM.ssm_apply(tp, txs[:, i:i + 1], cfg, state=ts)
        assert got.dtype == txs.dtype and ts["conv"].dtype == torch.float32
        _close(got, want, tol)
    _close(ts["ssm"], js["ssm"], tol)
    _close(ts["conv"], js["conv"], tol)


# --- whole models ------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """arch, dtype -> (cfg, JAX params, port params), built once."""
    cache = {}

    def get(arch, dtype):
        if (arch, dtype) not in cache:
            cfg = get_config(arch).reduced()
            jcfg = j_config(arch).reduced()
            jdt, tdt = DT[dtype]
            jp = JT.init_params(jcfg, jax.random.PRNGKey(1), dtype=jdt)
            tp = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                      dtype=tdt, device="cpu")
            cache[arch, dtype] = (cfg, jcfg, jp, tp)
        return cache[arch, dtype]
    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_reference(models, arch):
    """`init_params` builds the reference's tree: same keys, shapes and
    (per leaf) dtypes; `lm_params_from_numpy` carries it across."""
    cfg, jcfg, jp, tp = models(arch, "bf16")
    mine = PT.init_params(cfg, 0, device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat_j:
        keys = [p.key for p in path]
        t, m = tp, mine
        for k in keys:
            t, m = t[k], m[k]
        assert tuple(t.shape) == leaf.shape == tuple(m.shape), keys
        want = torch.float32 if leaf.dtype == jnp.float32 else torch.bfloat16
        assert t.dtype == m.dtype == want, keys
        np.testing.assert_array_equal(_np(t), np.asarray(leaf, np.float32))
    assert len(flat_j) == sum(1 for _ in _leaves(mine))


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _inputs(cfg, toks, dtype, seed=30, patches=8):
    """The same batch for both packages: the tokens, and whisper's frames
    (B, F, d) or qwen2-vl's `patches` patch embeddings (B, P, d), drawn
    from a seed in the working dtype."""
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.as_tensor(toks)}
    b = toks.shape[0]
    if cfg.family == "audio":
        jb["frames"], tb["frames"] = _pair(
            seed, (b, cfg.encoder_frames, cfg.d_model), dtype)
    if cfg.frontend == "vision" and patches:
        jb["patch_embeds"], tb["patch_embeds"] = _pair(
            seed + 1, (b, patches, cfg.d_model), dtype)
    return jb, tb


def _routed_forward(monkeypatch, cfg, jcfg, jp, tp, jb, tb, impl, jimpl):
    """Both forwards' hidden states, with each MoE layer's float32 router
    logits (T, E) recorded on both sides. The reference runs eagerly
    (`jax.disable_jit`, no remat), so that its logits are concrete."""
    jrec, prec = [], []
    j_moe, p_moe = JT.moe_apply, PT.moe_apply

    def j_record(p, x, c, capacity_factor=1.25, **kw):
        jrec.append(np.asarray(x.reshape(-1, x.shape[-1]).astype(
            jnp.float32) @ p["router"]["w"]))
        return j_moe(p, x, c, capacity_factor=capacity_factor, **kw)

    def p_record(p, x, c, capacity_factor=1.25, **kw):
        prec.append(PM.route(p, x.reshape(-1, x.shape[-1]), c,
                             capacity_factor).logits.numpy())
        return p_moe(p, x, c, capacity_factor, **kw)
    monkeypatch.setattr(JT, "moe_apply", j_record)
    monkeypatch.setattr(PT, "moe_apply", p_record)
    with jax.disable_jit():
        want = JT.forward(dataclasses.replace(jcfg, remat=False), jp, jb,
                          jimpl)
    got = PT.forward(cfg, tp, tb, impl)
    monkeypatch.undo()
    return got, want, jrec, prec


def routing_flips(jrec, prec, k: int) -> set:
    """Tokens whose top-k expert set differs between the two packages at
    some layer. Each must be a near tie: its k-th minus (k+1)-th reference
    logit at most twice the largest gap between its two rows of logits
    (bf16 rounding moves the router's input); a flip past that fails."""
    flips = set()
    for lj, lp in zip(jrec, prec):
        set_j = np.sort(np.argsort(-lj, -1)[:, :k], -1)
        set_p = np.sort(np.argsort(-lp, -1)[:, :k], -1)
        rows = np.where((set_j != set_p).any(-1))[0]
        srt = -np.sort(-lj, -1)
        margin = srt[rows, k - 1] - srt[rows, k]
        gap = np.abs(lj - lp).max(-1)[rows]
        assert (margin <= 2 * gap).all(), (rows, margin, gap)
        flips |= set(rows.tolist())
    return flips


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(models, monkeypatch, arch, dtype):
    """MoE models are compared routing first: a token whose expert set
    differs (a near tie, `routing_flips`) takes another expert's output
    and is exempt from the bar, at most one token in ten."""
    cfg, jcfg, jp, tp = models(arch, dtype)
    toks = np.random.default_rng(16).integers(0, cfg.vocab_size, (2, 24))
    tol = F32 if dtype == "f32" else BF16
    jb, tb = _inputs(cfg, toks, dtype)
    for impl, jimpl in (("naive", "naive"), ("chunked", "xla_chunked")):
        held = np.ones(2 * 24, bool)
        if cfg.n_experts:
            got, want, jrec, prec = _routed_forward(
                monkeypatch, cfg, jcfg, jp, tp, jb, tb, impl, jimpl)
            assert len(jrec) == len(prec) == cfg.n_layers
            flips = routing_flips(jrec, prec, cfg.experts_per_token)
            assert len(flips) <= len(held) // 10, flips
            held[sorted(flips)] = False
        else:
            got = PT.forward(cfg, tp, tb, impl)
            want = JT.forward(jcfg, jp, jb, jimpl)
        assert got.shape == (2, 24, cfg.d_model)
        _close(PT.logits_from_hidden(cfg, tp, got).reshape(48, -1)[held],
               JT.logits_from_hidden(jcfg, jp, want).reshape(48, -1)[held],
               tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(models, arch, dtype):
    cfg, jcfg, jp, tp = models(arch, dtype)
    toks = np.random.default_rng(17).integers(0, cfg.vocab_size, (2, 8))
    jc = JT.init_cache(jcfg, 2, 8)
    tc = PT.init_cache(cfg, 2, 8, device="cpu")
    tol = F32_DECODE if dtype == "f32" else BF16
    if cfg.family == "audio":          # cross K/V primed from random frames
        jb, tb = _inputs(cfg, toks, dtype)
        jc["cross"] = JT.prime_cross_cache(jcfg, jp, jb)
        tc["cross"] = PT.prime_cross_cache(cfg, tp, tb)
        _close(tc["cross"]["k"], jc["cross"]["k"], tol)
    step = jax.jit(lambda p, c, t, i: JT.decode_step(jcfg, p, c, t, i))
    for i in range(8):
        want, jc = step(jp, jc, jnp.asarray(toks[:, i:i + 1], jnp.int32),
                        jnp.asarray(i, jnp.int32))
        got, tc = PT.decode_step(cfg, tp, tc,
                                 torch.as_tensor(toks[:, i:i + 1]), i)
        _close(got, want, tol)


def test_rolling_cache_decode_matches_full_forward():
    """A dense model with a window smaller than the sequence: the rolling
    cache (capacity = window) wraps, and decode still matches the
    windowed forward (on llama's dense family).
    The cache is float32 here, so the bar is the float32 one."""
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(),
                              sliding_window=8)
    tp = PT.init_params(cfg, 3, dtype=torch.float32, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(18).integers(
        0, cfg.vocab_size, (2, 20)))
    cache = PT.init_cache(cfg, 2, 20, dtype=torch.float32, device="cpu")
    assert cache["kv"]["k"].shape[3] == 8 and "pos" in cache["kv"]
    for i in range(20):
        got, cache = PT.decode_step(cfg, tp, cache, toks[:, i:i + 1], i)
    hidden = PT.forward(cfg, tp, {"tokens": toks}, "naive")
    want = PT.logits_from_hidden(cfg, tp, hidden)[:, -1]
    _close(got, want, F32)


# --- the slice as a whole ------------------------------------------------------

def test_serve_batch_tokens_identical_to_reference(models):
    """Reduced Zamba2 in float32: the port's `serve_batch` gives the JAX
    `serve_batch`'s tokens, token for token."""
    cfg, jcfg, jp, tp = models("zamba2-2.7b", "f32")
    prompts = np.random.default_rng(19).integers(0, cfg.vocab_size, (3, 12))
    want = j_serve_batch(jcfg, jp, prompts, 10)
    got = PS.serve_batch(cfg, tp, prompts, 10)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_step_matches_reference_pallas(models, dtype):
    """`make_prefill_step` against the JAX prefill through its Pallas
    kernels (interpret mode), and against the port's own cache path,
    which rounds keys and values into the bf16 cache and so is held to
    the reference's prefill/decode bar in either dtype."""
    cfg, jcfg, jp, tp = models("zamba2-2.7b", dtype)
    prompts = np.random.default_rng(20).integers(0, cfg.vocab_size, (2, 40))
    want = jax.jit(j_prefill(jcfg, impl="pallas"))(
        jp, {"tokens": jnp.asarray(prompts, jnp.int32)})
    reset_launches()
    got = make_prefill_step(cfg)(tp, {"tokens": torch.as_tensor(prompts)})
    assert got.shape == (2, cfg.vocab_size)
    assert KERNEL_LAUNCHES["flash_attention"] == KERNEL_LAUNCHES["ssd"] == 0
    _close(got, want, F32 if dtype == "f32" else BF16)
    trace = {}
    PS.serve_batch(cfg, tp, prompts, 1, trace=trace)
    _close(trace["prompt_logits"], got, BF16)


def test_greedy_blocks_equal_argmax():
    rng = np.random.default_rng(21)
    logits = rng.normal(0, 1, (5, 512)).astype(np.float32)
    logits[1, [7, 300]] = 9.0                     # a tie: the first wins
    for v in (512, 500):                          # blocked and unblocked
        got = _sharded_greedy(None, torch.from_numpy(logits[:, :v]))
        np.testing.assert_array_equal(got.numpy(), logits[:, :v].argmax(-1))
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(j_greedy(None, jnp.asarray(
                logits[:, :v]))))


def test_serve_step_returns_tokens(models):
    cfg, _, _, tp = models("zamba2-2.7b", "f32")
    cache = PT.init_cache(cfg, 2, 4, device="cpu")
    toks = torch.tensor([[1], [2]])
    ids, cache = make_serve_step(cfg, return_logits=False)(
        tp, cache, {"tokens": toks, "cache_index": 0})
    assert ids.dtype == torch.int32 and ids.shape == (2,)


def test_serve_cli_on_cpu(capsys):
    tokens = PS.main(["--arch", "zamba2-2.7b", "--reduced", "--requests",
                      "2", "--prompt-len", "4", "--gen", "3", "--device",
                      "cpu"])
    assert tokens.shape == (2, 3)
    assert "zamba2-2.7b on cpu" in capsys.readouterr().out


def test_unknown_family_raises():
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(),
                              family="diffusion")
    for build in (lambda: PT.init_params(cfg, 0, device="cpu"),
                  lambda: lm_params_from_numpy(cfg, {}, device="cpu"),
                  lambda: PT.init_cache(cfg, 1, 4, device="cpu")):
        with pytest.raises(ValueError, match="unknown family"):
            build()


# --- the moe, audio and vlm families ------------------------------------------

@pytest.mark.parametrize("length,d", [(32, 64), (1500, 384)])
def test_sinusoidal_positions(length, d):
    """Whisper's position table (reduced and full), bit for bit."""
    got = PL.sinusoidal_positions(length, d)
    assert got.dtype == torch.float32 and got.shape == (length, d)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        JL.sinusoidal_positions(length, d)))


@pytest.mark.parametrize("lq", [12, 40])
@pytest.mark.parametrize("impl", ["naive", "chunked"])
def test_cross_attention_matches_reference(impl, lq):
    """Whisper's decoder-to-encoder attention: keys and values from x_kv
    (32 frames), no rotary, no mask; 40 queries is Lq > Lk."""
    cfg, jp, tp = _attn("whisper-tiny", "f32")
    jx, tx = _pair(22, (2, lq, cfg.d_model))
    jkv, tkv = _pair(23, (2, cfg.encoder_frames, cfg.d_model))
    got, cache = PA.attention_apply(tp, tx, cfg, None, causal=False,
                                    impl=impl, x_kv=tkv)
    want, _ = JA.attention_apply(
        jp, jx, cfg, None, causal=False, x_kv=jkv,
        impl="naive" if impl == "naive" else "xla_chunked")
    assert cache is None and got.shape == (2, lq, cfg.d_model)
    _close(got, want, F32)
    with pytest.raises(ValueError, match="CUDA"):
        PA.attention_apply(tp, tx, cfg, None, causal=False, impl="cuda",
                           x_kv=tkv)


def test_whisper_cross_decode_matches_reference(models):
    """`prime_cross_cache` over random frames, then `_cross_decode` of one
    token against one layer's primed keys and values."""
    cfg, jcfg, jp, tp = models("whisper-tiny", "f32")
    jf, tf = _pair(24, (2, cfg.encoder_frames, cfg.d_model))
    jkv = JT.prime_cross_cache(jcfg, jp, {"frames": jf})
    tkv = PT.prime_cross_cache(cfg, tp, {"frames": tf})
    assert tkv["k"].shape == (cfg.n_layers, 2, cfg.n_kv_heads,
                              cfg.encoder_frames, cfg.head_dim)
    _close(tkv["v"], jkv["v"], F32)
    jx, tx = _pair(25, (2, 1, cfg.d_model))
    got = PT._cross_decode(cfg, PT.layer(tp["cross_layers"], 1), tx,
                           PT.layer(tkv, 1))
    want = JT._cross_decode(cfg, jax.tree.map(lambda a: a[1],
                                              jp["cross_layers"]), jx,
                            jax.tree.map(lambda a: a[1], jkv))
    _close(got, want, F32)


def test_vlm_patch_embeds_overwrite_first_positions(models):
    """qwen2-vl's stub frontend: 8 patch embeddings take the first 8
    positions, whatever tokens stood there."""
    cfg, jcfg, jp, tp = models("qwen2-vl-72b", "f32")
    toks = np.random.default_rng(26).integers(0, cfg.vocab_size, (2, 24))
    jb, tb = _inputs(cfg, toks, "f32")
    got = PT.forward(cfg, tp, tb, "chunked")
    _close(got, JT.forward(jcfg, jp, jb, "xla_chunked"), F32)
    other = toks.copy()
    other[:, :8] = (other[:, :8] + 1) % cfg.vocab_size
    again = PT.forward(cfg, tp, {**tb, "tokens": torch.as_tensor(other)},
                       "chunked")
    assert torch.equal(again, got)
    plain = PT.forward(cfg, tp, {"tokens": tb["tokens"]}, "chunked")
    assert not torch.equal(plain, got)


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_batch_families_match_reference(models, arch):
    """Reduced mixtral, arctic and qwen2-vl in float32, whisper in bf16
    (both packages prime its cross cache from zero bf16 frames, which a
    float32 model refuses): the port's `serve_batch` gives the JAX
    `serve_batch`'s tokens, token for token."""
    cfg, jcfg, jp, tp = models(arch, "bf16" if arch == "whisper-tiny"
                               else "f32")
    prompts = np.random.default_rng(27).integers(0, cfg.vocab_size, (2, 6))
    want = j_serve_batch(jcfg, jp, prompts, 5)
    got = PS.serve_batch(cfg, tp, prompts, 5)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("arch", ["whisper-tiny", "qwen2-vl-72b"])
def test_prefill_step_passes_frames_and_patches(models, arch):
    """`make_prefill_step` hands frames (whisper) and patch embeddings
    (qwen2-vl) to `forward`, against the JAX prefill through its Pallas
    flash kernel (interpret mode; whisper's encoder stays xla_chunked)."""
    cfg, jcfg, jp, tp = models(arch, "f32")
    toks = np.random.default_rng(28).integers(0, cfg.vocab_size, (2, 16))
    jb, tb = _inputs(cfg, toks, "f32")
    want = jax.jit(j_prefill(jcfg, impl="pallas"))(jp, jb)
    got = make_prefill_step(cfg)(tp, tb)
    _close(got, want, F32)
    # other frames, or no patches, give other logits: the batch is read
    other = {k: torch.zeros_like(v) if k == "frames" else v
             for k, v in tb.items() if k != "patch_embeds"}
    assert not torch.equal(make_prefill_step(cfg)(tp, other), got)


def test_serve_cli_whisper_on_cpu(capsys):
    tokens = PS.main(["--arch", "whisper-tiny", "--reduced", "--requests",
                      "2", "--prompt-len", "4", "--gen", "3", "--device",
                      "cpu"])
    assert tokens.shape == (2, 3)
    assert "whisper-tiny on cpu" in capsys.readouterr().out
