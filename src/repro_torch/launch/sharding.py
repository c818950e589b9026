"""Sharding strategies and the activation-constraint hook, as
`repro.launch.sharding` has them, on `torch.distributed.DeviceMesh` and
DTensor.

Three strategies:

  * fsdp2d — parameters 2D-sharded (row dim over 'data', column dim over
    'model'; ZeRO-3 x tensor-storage), activations batch-sharded over
    ('pod', 'data'). Head-count agnostic: it places every architecture
    and shape. DTensor gathers the weights where an op needs them whole
    (FSDP semantics).
  * tp — Megatron tensor parallelism over 'model' (attention heads, FFN
    hidden, vocab) with FSDP over 'data'.
  * tp_serve — pure tensor-parallel weights for serving: no row ('data')
    sharding, so decode gathers no weights.

A rule gives a `PartitionSpec` (this module's own: one entry a tensor
dim, each None, a mesh axis name or a tuple of names), chosen exactly as
the reference chooses it: the first fully divisible candidate, else the
first candidate with its non-divisible axes dropped. `placements` maps a
spec onto the DTensor placements of a mesh, one per mesh dim; a tensor
dim over ('pod', 'data') is `Shard(d)` on both, which DTensor splits
left to right, pod-major, as XLA does.

Model code calls `constrain(x, tag)`; the active strategy maps the tag to
a spec and the DTensor is redistributed to it. On a plain tensor, and
outside a strategy, the hook is the identity, so the single-device paths
run the same model code unchanged.
"""
from __future__ import annotations

import functools
import math
import re
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from types import SimpleNamespace

from repro_torch.launch.mesh import mesh_spec
from repro_torch.tree import leaves_with_path, tree_map, unflatten

_state = threading.local()


class PartitionSpec(tuple):
    """One entry a tensor dim: None, a mesh axis, or a tuple of axes (a
    one-axis tuple is that axis, as jax normalizes it)."""

    def __new__(cls, *parts):
        def norm(p):
            if isinstance(p, (list, tuple)):
                p = tuple(p)
                return p[0] if len(p) == 1 else p
            return p
        return super().__new__(cls, tuple(norm(p) for p in parts))

    def __repr__(self):
        return "P" + super().__repr__()


P = PartitionSpec


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (a DeviceMesh, or a MeshSpec for the rules
    alone)."""
    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    @property
    def is_fully_replicated(self) -> bool:
        sizes = mesh_spec(self.mesh).shape
        return all(sizes[a] == 1 for a in _axes(self.spec))


def _axes(spec) -> list:
    out = []
    for entry in spec:
        if entry is None:
            continue
        out += list(entry) if isinstance(entry, tuple) else [entry]
    return out


def placements(spec, mesh) -> tuple:
    """DTensor placements of `spec` on `mesh`, one per mesh dim: Shard(d)
    on every mesh dim that tensor dim d's entry names, Replicate on the
    others. A tuple entry must name its axes in mesh order (DTensor
    splits a dim over several mesh dims left to right)."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh_spec(mesh).axis_names
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = list(entry) if isinstance(entry, tuple) else [entry]
        idx = [names.index(a) for a in axes]
        assert idx == sorted(idx), \
            f"{spec}: axes {axes} out of mesh order {names}"
        for i in idx:
            assert isinstance(out[i], Replicate), \
                f"{spec}: mesh axis {names[i]} shards two dims"
            out[i] = Shard(d)
    return tuple(out)


def current_strategy():
    return getattr(_state, "strategy", None)


@contextmanager
def use_strategy(strategy, mesh):
    """`strategy` on `mesh` for the model code run inside. On a
    DeviceMesh, plain tensors that code makes (positions, masks,
    constants) count as replicated where they meet DTensors."""
    prev = (getattr(_state, "strategy", None),
            getattr(_state, "mesh", None))
    _state.strategy, _state.mesh = strategy, mesh
    try:
        if hasattr(mesh, "mesh_dim_names"):
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                yield
        else:
            yield
    finally:
        _state.strategy, _state.mesh = prev


def constrain(x, tag: str):
    """x redistributed to the active strategy's spec for `tag`; x itself
    when it is no DTensor, outside a strategy, or for a tag the strategy
    has no rule for."""
    strat = getattr(_state, "strategy", None)
    mesh = getattr(_state, "mesh", None)
    if strat is None or mesh is None or not _is_dtensor(x):
        return x
    rule = strat.activation_rules.get(tag)
    if rule is None:
        return x
    spec = activation_spec(rule, tuple(x.shape), mesh_spec(mesh))
    want = placements(spec, mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def replicate(x, dims=None):
    """x with tensor dims `dims` (None: all) whole on every rank and no
    pending partial sums: a DTensor is redistributed where it has to be
    (for ops DTensor has no sharding rule for, or whose rule cannot be
    reduced afterwards); a plain tensor is returned as it is."""
    if not _is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    nd = x.ndim
    keep = None if dims is None else {d % nd for d in dims}

    def settle(p):
        if isinstance(p, Shard) and keep is not None and p.dim not in keep:
            return p
        return Replicate()                  # a Partial, or a dim of dims

    want = tuple(settle(p) for p in x.placements)
    return x if want == tuple(x.placements) else \
        x.redistribute(x.device_mesh, want)


def splittable(x, dim: int, lead: int):
    """x ready to have dim `dim` unflattened into (lead, rest): a DTensor
    whose split of that dim does not divide `lead` has the dim gathered
    first (DTensor cannot unflatten it); anything else is x."""
    if lead % max(split_ways(x, dim), 1) == 0:
        return x
    return replicate(x, dims=(dim,))


def fsdp_weight(w):
    """w gathered along the mesh's data axes ('pod', 'data') for use: the
    FSDP all-gather of a weight whose storage is split by rows over the
    data-parallel ranks (its 'model' split stays). Without it DTensor
    may move the activations instead, which are larger. A plain tensor
    is returned as it is."""
    if not _is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate, Shard
    names = w.device_mesh.mesh_dim_names
    want = tuple(Replicate() if isinstance(p, Shard)
                 and names[m] in ("pod", "data") else p
                 for m, p in enumerate(w.placements))
    return w if want == tuple(w.placements) else \
        w.redistribute(w.device_mesh, want)


def grad_like(x):
    """x itself, with its gradient laid out as x is as soon as it is
    computed (a partial sum reduce-scattered into x's shards: FSDP's
    per-layer reduce-scatter, where the gradient would otherwise stay
    whole and partial on every rank until the step ends). A plain tensor
    is returned as it is."""
    if not _is_dtensor(x):
        return x
    return _functions().grad_like.apply(x)


@functools.cache
def _functions():
    """The autograd Functions, made on first use (importing this module
    touches no torch.distributed)."""
    import torch

    class GradLike(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            ctx.mesh, ctx.placements = x.device_mesh, tuple(x.placements)
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            if tuple(g.placements) == ctx.placements:
                return g
            return g.redistribute(ctx.mesh, ctx.placements)

    class GradContiguous(torch.autograd.Function):
        """Identity on a local shard whose gradient is made contiguous:
        DTensor wraps the gradient of `to_local()` with the forward's
        (contiguous) strides, whatever the local gradient's layout."""
        @staticmethod
        def forward(ctx, x):
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            return g.contiguous()

    return SimpleNamespace(grad_contiguous=GradContiguous,
                           grad_like=GradLike)


def local_map(fn, args, arg_dims, out_dims):
    """fn on each rank's shards, for a function that is independent along
    some dims (the batch, the heads): the first argument leads, keeping
    its splits of the dims `arg_dims[0]` names and gathering the rest;
    `arg_dims[i]` names, for argument i, its dim that goes with each of
    the lead's (None: the argument has none and is whole there), and
    `out_dims` the result's. Every argument is redistributed to match,
    fn runs on the local tensors, and the result is a DTensor again.
    Without a DTensor among the arguments it is fn(*args).

    This spares DTensor's sharding search over ops it would otherwise
    plan one by one (on a three-dim mesh a batched product of a dim split
    over two mesh dims takes it minutes), and keeps the work local."""
    lead = args[0]
    if not _is_dtensor(lead):
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = lead.device_mesh

    def others(a, dims):
        return [d for d in range(a.ndim) if d not in dims]

    lead = replicate(lead, dims=others(lead, arg_dims[0]))
    # mesh dim -> the index (into arg_dims) of the lead dim it splits
    split = [arg_dims[0].index(p.dim) if isinstance(p, Shard) else None
             for p in lead.placements]

    def placed(dims):
        return tuple(Replicate() if k is None or dims[k] is None
                     else Shard(dims[k]) for k in split)

    local = []
    for a, dims in zip(args, arg_dims):
        if _is_dtensor(a):
            want = placed(dims)
            if tuple(a.placements) != want:
                a = replicate(a, dims=others(a, dims))
                a = a.redistribute(mesh, want)
            # an argument whole along a split of the lead (the SSD's
            # per-head vectors over the batch, its B and C over the
            # heads) gathers a partial gradient on each rank: a sum
            grads = tuple(Partial() if k is not None and dims[k] is None
                          else p for k, p in zip(split, want))
            a = _functions().grad_contiguous.apply(
                a.to_local(grad_placements=grads))
        local.append(a)
    out = fn(*local).contiguous()
    pl = placed(out_dims)
    shape = list(out.shape)
    for p, n in zip(pl, mesh.shape):
        if isinstance(p, Shard):
            shape[p.dim] *= n
    stride = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    return DTensor.from_local(out, mesh, pl, run_check=False,
                              shape=tuple(shape), stride=tuple(stride))


def split_ways(x, dim: int) -> int:
    """Into how many shards tensor dim `dim` of x is split: 0 for a plain
    tensor or an unsplit dim (a split over mesh dims of size 1 is 1)."""
    if not _is_dtensor(x):
        return 0
    from torch.distributed.tensor import Shard
    ways = [n for p, n in zip(x.placements, x.device_mesh.shape)
            if isinstance(p, Shard) and p.dim == dim % x.ndim]
    return int(math.prod(ways)) if ways else 0


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def activation_spec(rule, shape: tuple, mesh) -> PartitionSpec:
    """The spec `constrain` picks for an activation of `shape`."""
    candidates = rule if isinstance(rule, (list, tuple)) \
        and not isinstance(rule, P) else [rule]
    fitted = [_fit_spec_to_rank(s, len(shape)) for s in candidates]
    for s in fitted:
        if _divisible(shape, s, mesh):
            return s
    # keep the divisible axes (e.g. batch) and release the rest
    return _drop_nondivisible(shape, fitted[0], mesh)


def _fit_spec_to_rank(spec, rank: int) -> PartitionSpec:
    parts = list(spec)
    if len(parts) < rank:
        parts = parts + [None] * (rank - len(parts))
    return P(*parts[:rank])


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        size = 1
        for a in axis:
            size *= _axis_size(mesh, a)
        return size
    return mesh.shape[axis] if axis in mesh.axis_names else 0


def _divisible(shape, spec, mesh) -> bool:
    for dim, axis in zip(shape, spec):
        size = _axis_size(mesh, axis)
        if size == 0:
            return False            # axis not present in this mesh
        if size > 1 and dim % size != 0:
            return False
    return True


@dataclass(frozen=True)
class Strategy:
    name: str
    #: regex on '/'.joined param path -> spec builder over dims
    param_rules: tuple = ()
    activation_rules: dict = field(default_factory=dict)

    def param_spec(self, path: str, shape: tuple, mesh) -> PartitionSpec:
        mesh = mesh_spec(mesh)
        for pattern, spec in self.param_rules:
            if re.search(pattern, path):
                # a rule may carry fallback candidates (tuple of specs):
                # the first fully-divisible one wins — e.g. MoE expert
                # stacks shard the expert dim when E divides the axis,
                # else the within-expert dims (mixtral E=8 < data=16)
                candidates = spec if isinstance(spec, (list, tuple)) \
                    and not isinstance(spec, P) else [spec]
                fitted = [_fit_spec_to_rank_nd(s, len(shape))
                          for s in candidates]
                for s in fitted:
                    if _divisible(shape, s, mesh):
                        return s
                return _drop_nondivisible(shape, fitted[0], mesh)
        return P(*([None] * len(shape)))


def _fit_spec_to_rank_nd(spec, rank: int) -> PartitionSpec:
    """Right-align the spec onto the trailing dims (stacked-layer params
    carry leading layer/group dims that stay unsharded)."""
    parts = list(spec)
    if len(parts) < rank:
        parts = [None] * (rank - len(parts)) + parts
    return P(*parts[-rank:])


def _drop_nondivisible(shape, spec, mesh) -> PartitionSpec:
    parts = []
    for dim, axis in zip(shape, spec):
        size = _axis_size(mesh, axis)
        parts.append(axis if size and dim % max(size, 1) == 0 and size > 1
                     else None)
    return P(*parts)


def _dp(mesh_axes) -> tuple:
    return ("pod", "data") if "pod" in mesh_axes else ("data",)


def make_strategy(name: str, mesh, cfg=None) -> Strategy:
    dp = _dp(mesh_spec(mesh).axis_names)
    moe_rules = {
        # (E, C, d) buffers: expert-sharded when E divides, else
        # capacity-sharded (mixtral E=8 < data=16)
        "moe_buffer": (P("data", None, None), P(None, "data", "model")),
        "moe_hidden": (P("data", None, "model"), P(None, "data", "model")),
        "moe_tokens": P(dp, None),
        "moe_routing": P(dp, None),
        "ssm_heads": P(dp, None, "model", None),
    }
    if name == "fsdp2d":
        return Strategy(
            name="fsdp2d",
            param_rules=(
                # embeddings: vocab over model (gather-friendly)
                (r"embed/w$", P("model", "data")),
                (r"lm_head/w$", P("data", "model")),
                # MoE expert stacks (E, d_in, d_out): shard experts over
                # data (expert-parallel storage) and d_out over model;
                # when E < data (mixtral: 8 < 16) fall back to 2D
                # within-expert sharding so optimizer state still
                # shards 256-way
                (r"moe/(gate|up|down)/?w?$",
                 (P("data", None, "model"), P(None, "data", "model"))),
                (r"router/w$", P(None, None)),
                # conv / small ssm vectors: replicate
                (r"conv_w$|conv_b$|a_log$|dt_bias$|d_skip$", P(None)),
                # biases and norms: replicate
                (r"/b$|scale$|bias$", P(None)),
                # every remaining 2D matmul weight: row over data,
                # col over model
                (r"/w$", P("data", "model")),
            ),
            activation_rules={
                "residual": P(dp, None, None),
                "logits": P(dp, None, "model"),
                "kv_cache": P(dp, None, "model", None),
                "logits_blocks": P(dp, "model", None),
                **moe_rules,
            },
        )
    if name == "tp":
        return Strategy(
            name="tp",
            param_rules=(
                (r"embed/w$", P("model", "data")),
                (r"lm_head/w$", P("data", "model")),
                (r"moe/(gate|up|down)/?w?$",
                 (P("data", None, "model"), P(None, "data", "model"))),
                (r"router/w$", P(None, None)),
                (r"conv_w$|conv_b$|a_log$|dt_bias$|d_skip$", P(None)),
                (r"attn/w[qkv]/w$", P("data", "model")),
                (r"attn/wo/w$", P("model", "data")),
                (r"(gate|up)/w$", P("data", "model")),
                (r"down/w$", P("model", "data")),
                (r"in_proj/w$", P("data", "model")),
                (r"out_proj/w$", P("model", "data")),
                (r"/b$|scale$|bias$", P(None)),
                (r"/w$", P("data", "model")),
            ),
            activation_rules={
                "residual": P(dp, None, None),
                "logits": P(dp, None, "model"),
                "attn_heads": P(dp, "model", None, None),
                "attn_kv_heads": P(dp, "model", None, None),
                "attn_out": P(dp, None, "model"),
                "ffn_hidden": P(dp, None, "model"),
                "kv_cache": P(dp, "model", None, None),
                "logits_blocks": P(dp, "model", None),
                **moe_rules,
            },
        )
    if name == "tp_serve":
        # no row ('data') sharding, so decode has no per-layer FSDP
        # weight gathers — only the two small activation all-reduces per
        # layer (classic Megatron inference). Memory: params/16 per
        # device, no optimizer state at serve time.
        return Strategy(
            name="tp_serve",
            param_rules=(
                (r"embed/w$", P("model", None)),
                (r"lm_head/w$", P(None, "model")),
                (r"moe/(gate|up|down)/?w?$",
                 (P("data", None, "model"), P(None, None, "model"))),
                (r"router/w$", P(None, None)),
                (r"conv_w$|conv_b$|a_log$|dt_bias$|d_skip$", P(None)),
                (r"attn/w[qkv]/w$", P(None, "model")),
                (r"attn/wo/w$", P("model", None)),
                (r"(gate|up)/w$", P(None, "model")),
                (r"down/w$", P("model", None)),
                (r"in_proj/w$", P(None, "model")),
                (r"out_proj/w$", P("model", None)),
                (r"/b$|scale$|bias$", P(None)),
                (r"/w$", P(None, "model")),
            ),
            activation_rules={
                "residual": P(dp, None, None),
                "logits": P(dp, None, "model"),
                "logits_blocks": P(dp, "model", None),
                "attn_heads": P(dp, "model", None, None),
                "attn_kv_heads": (P(dp, "model", None, None),
                                  P(dp, None, None, None)),
                "attn_out": P(dp, None, "model"),
                "ffn_hidden": P(dp, None, "model"),
                "kv_cache": (P(dp, "model", None, None),
                             P(dp, None, "model", None)),
                **moe_rules,
            },
        )
    raise KeyError(name)


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def _map_with_path(fn, tree):
    flat = leaves_with_path(tree)
    return unflatten(tree, [fn(path, leaf) for path, leaf in flat])


def param_shardings(strategy: Strategy, mesh, params_shape) -> dict:
    """Tree of NamedShardings matching a params (shape) tree."""
    spec = mesh_spec(mesh)
    return _map_with_path(lambda path, leaf: NamedSharding(
        mesh, strategy.param_spec(_path_str(path), tuple(leaf.shape),
                                  spec)), params_shape)


def opt_shardings(strategy: Strategy, mesh, opt_shape) -> dict:
    """Optimizer-state shardings derived from the parameter rules.

    AdamW moments ('m/...', 'v/...') shard exactly like their parameter.
    Adafactor row stats ('stats/<param>/vr') drop the parameter's last
    spec entry; column stats ('vc') drop the second-to-last. Scalars
    ('count') replicate.
    """
    ms = mesh_spec(mesh)

    def one(path, leaf):
        parts = [str(p) for p in path]
        shape, ndim = tuple(leaf.shape), len(leaf.shape)
        if parts and parts[0] in ("m", "v"):
            spec = strategy.param_spec("/".join(parts[1:]), shape, ms)
        elif parts and parts[0] == "stats":
            stat = parts[-1]
            # derive from a pseudo parameter spec of matching rank + 1
            pseudo = strategy.param_spec("/".join(parts[1:-1]),
                                         shape + (1,), ms)
            pparts = list(pseudo)
            if stat == "vc":                    # minus second-to-last
                spec = P(*(pparts[:-2] + pparts[-1:]))
            else:                   # 'vr' (minus last) or the 'v' stat
                spec = P(*pparts[:-1])
            spec = _drop_nondivisible(shape, _fit_spec_to_rank(spec, ndim),
                                      ms)
        else:
            spec = P(*([None] * ndim))
        if not _divisible(shape, spec, ms):
            spec = _drop_nondivisible(shape, spec, ms)
        return NamedSharding(mesh, spec)

    return _map_with_path(one, opt_shape)


def batch_shardings(strategy: Strategy, mesh, batch_shape) -> dict:
    """Batch inputs: leading dim over (pod, data) when divisible."""
    ms = mesh_spec(mesh)
    dp = _dp(ms.axis_names)

    def spec_for(leaf):
        ndim = len(leaf.shape)
        if ndim == 0:
            return NamedSharding(mesh, P())
        spec = P(dp, *([None] * (ndim - 1)))
        if not _divisible(tuple(leaf.shape), spec, ms):
            # batch=1 long-context cells: replicate batch
            spec = P(*([None] * ndim))
        return NamedSharding(mesh, spec)

    return tree_map(spec_for, batch_shape)


def cache_shardings(strategy: Strategy, mesh, cache_shape) -> dict:
    """KV caches: batch over dp, sequence dim over 'model' (stacked
    layout (L, B, H, S, hd)); SSM states: batch over dp, heads over
    'model' when divisible."""
    ms = mesh_spec(mesh)
    dp = _dp(ms.axis_names)

    def spec_for(path, leaf):
        names = [str(p) for p in path if isinstance(p, str)]
        shape, ndim = tuple(leaf.shape), len(leaf.shape)
        if "ssm" in names and ndim == 5:        # (L, B, H, P, N) states
            spec = P(None, dp, "model", None, None)
        elif ndim == 5:             # (L, B, H, S, hd) kv stack
            spec = P(None, dp, None, "model", None)
        elif ndim == 4 and "conv" in names:
            spec = P(None, dp, None, "model")
        elif ndim == 2:             # pos buffers (L, S)
            spec = P(None, "model")
        else:
            spec = P(*([None] * ndim))
        if not _divisible(shape, spec, ms):
            spec = _drop_nondivisible(shape, spec, ms)
        return NamedSharding(mesh, spec)

    return _map_with_path(spec_for, cache_shape)


def arg_shardings(strategy: Strategy, mesh, names, args) -> list:
    """The shardings of a step's arguments, each named "params",
    "opt_state", "cache" or "batch" (as `launch.steps.step_for_shape`
    names them)."""
    rule = {"params": param_shardings, "opt_state": opt_shardings,
            "cache": cache_shardings}
    return [rule.get(n, batch_shardings)(strategy, mesh, a)
            for n, a in zip(names, args)]


# --------------------------------------------------------------------------
# trees of DTensors
# --------------------------------------------------------------------------

def distribute(tree, shardings):
    """Each leaf of `tree` (whole, on every rank) placed as its sharding
    says: a tree of DTensors. Rank 0's values are the ones kept."""
    from torch.distributed.tensor import distribute_tensor
    return tree_map(lambda t, s: distribute_tensor(t, s.mesh, s.placements),
                    tree, shardings)


def like(x, ref):
    """x laid out as `ref` (a DTensor: redistributed to its placements);
    x itself when `ref` is a plain tensor."""
    if not _is_dtensor(ref) or tuple(x.placements) == tuple(ref.placements):
        return x
    return x.redistribute(ref.device_mesh, ref.placements)


def local(x):
    """This rank's shard of a DTensor; a plain tensor as it is."""
    return x.to_local() if _is_dtensor(x) else x


def gather(tree):
    """Each DTensor leaf gathered whole on every rank (a plain tensor
    leaf as it is)."""
    return tree_map(lambda t: t.full_tensor() if _is_dtensor(t) else t,
                    tree)
