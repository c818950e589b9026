"""The sharded train step run for real, against the plain one.

`step_for_shape`'s train step runs on DTensor parameters, optimizer
state and batch, placed by a strategy on a DeviceMesh of N ranks: gloo on
the CPU, NCCL on the card (rank r on card r). Each rank is a process of
its own, joined through a `FileStore` in a temporary directory (no TCP
port). The same seeded state and batch also go through the plain step in
the calling process, so the two can be held against each other:

    PYTHONPATH=src python -m repro_torch.launch.sharded --arch llama3-8b \\
        --reduced --mesh 2,2 --steps 2 --device cpu --out run.pt

`run.pt` holds, for "plain" and "sharded": the loss, grad norm and
gradients of each step, the final parameters (gradients and parameters
gathered whole), and for MoE models the router logits, expert ids and
kept flags of every dispatch; for "sharded" also the leaves whose shard
shape on some rank is not the one its spec gives.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from contextlib import contextmanager

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import MeshSpec, build_mesh
from repro_torch.launch.steps import loss_and_grads, make_train_step
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.optim import get_optimizer
from repro_torch.tree import leaves_with_path, tree_map


def make_case(cfg, batch: int, seq: int, seed: int, dtype, device,
              patches: int = 4):
    """Seeded (params, opt_state, batch) of `cfg` on `device`."""
    params = T.init_params(cfg, seed, dtype=dtype, device="cpu")
    rng = np.random.default_rng(seed + 1)
    arrays = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq)),
              "labels": rng.integers(0, cfg.vocab_size, (batch, seq))}
    if cfg.family == "audio":
        arrays["frames"] = rng.normal(0, 1, (batch, cfg.encoder_frames,
                                             cfg.d_model))
    if cfg.frontend == "vision":
        arrays["patch_embeds"] = rng.normal(0, 1, (batch, patches,
                                                   cfg.d_model))
    batch_t = {k: torch.from_numpy(v.astype(
        np.int32 if k in ("tokens", "labels") else np.float32))
        for k, v in arrays.items()}
    params = tree_map(lambda t: t.to(device), params)
    batch_t = {k: v.to(device) for k, v in batch_t.items()}
    opt_state = get_optimizer(cfg.optimizer).init(params)
    return params, opt_state, batch_t


@contextmanager
def record_routing(out: list):
    """Appends (logits, expert_ids, keep) of every MoE dispatch, gathered
    whole on the CPU, to `out` while entered."""
    route = moe.route

    def recording(*args, **kw):
        r = route(*args, **kw)
        out.append(tuple(shd.replicate(t).to_local().detach().cpu()
                         if hasattr(t, "to_local") else t.detach().cpu()
                         for t in (r.logits, r.expert_ids, r.keep)))
        return r

    moe.route = recording
    try:
        yield
    finally:
        moe.route = route


def expected_local_shape(shape, spec, sizes: dict) -> tuple:
    """A shard's shape under `spec` on a mesh of axis `sizes`."""
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if entry is None else \
            (entry if isinstance(entry, tuple) else (entry,))
        out.append(dim // int(np.prod([sizes[a] for a in axes] or [1])))
    return tuple(out)


def shard_shape_errors(tree, shardings, sizes: dict) -> list:
    """Leaves whose local shard is not the shape their spec gives."""
    bad = []
    specs = dict(leaves_with_path(shardings))
    for path, t in leaves_with_path(tree):
        want = expected_local_shape(tuple(t.shape), specs[path].spec, sizes)
        got = tuple(t.to_local().shape)
        if got != want:
            bad.append(("/".join(map(str, path)), got, want))
    return bad


def run_steps(cfg, params, opt_state, batch, steps: int, lr: float,
              mesh=None, strategy: str = "fsdp2d",
              microbatches: int = 1) -> dict:
    """`steps` train steps from the given state; on `mesh` the state is
    placed by `strategy` first. Returns the metrics, the final state
    gathered whole on the CPU and the MoE routing."""
    step = make_train_step(cfg, lr=lr, microbatches=microbatches)
    routing = []
    rec = {"loss": [], "grad_norm": [], "grads": [], "step_s": []}
    if mesh is not None:
        strat = shd.make_strategy(strategy, mesh)
        names = ("params", "opt_state", "batch")
        shardings = shd.arg_shardings(strat, mesh, names,
                                      (params, opt_state, batch))
        params, opt_state, batch = (shd.distribute(a, s) for a, s in
                                    zip((params, opt_state, batch),
                                        shardings))
    for _ in range(steps):
        # each step's gradient (gathered whole), held apart from the step
        if mesh is None:
            grads = loss_and_grads(cfg, params, batch)[1]
        else:
            with shd.use_strategy(strat, mesh):
                grads = shd.gather(loss_and_grads(cfg, params, batch)[1])
        rec["grads"].append(tree_map(lambda t: t.detach().cpu(), grads))
        del grads
        t0 = time.perf_counter()
        with record_routing(routing):
            if mesh is None:
                params, opt_state, m = step(params, opt_state, batch)
            else:
                with shd.use_strategy(strat, mesh):
                    params, opt_state, m = step(params, opt_state, batch)
        loss = float(shd.replicate(m["loss"]).to_local()
                     if mesh is not None else m["loss"])
        gnorm = float(shd.replicate(m["grad_norm"]).to_local()
                      if mesh is not None else m["grad_norm"])
        rec["step_s"].append(time.perf_counter() - t0)
        rec["loss"].append(loss)
        rec["grad_norm"].append(gnorm)
    if mesh is not None:
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        rec["shard_errors"] = (
            shard_shape_errors(params, shardings[0], sizes)
            + shard_shape_errors(opt_state, shardings[1], sizes))
        params = shd.gather(params)
    rec["params"] = tree_map(lambda t: t.detach().cpu(), params)
    rec["routing"] = routing
    return rec


def _rank_main(rank: int, args, store_path: str, out_path: str):
    import torch.distributed as dist
    world = int(np.prod(args.mesh))
    cuda = args.device != "cpu"
    if cuda:
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)        # the ranks share the host's cores
    dev = torch.device(f"cuda:{rank}") if cuda else torch.device("cpu")
    dist.init_process_group("nccl" if cuda else "gloo",
                            store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        cfg = _config(args)
        params, opt_state, batch = make_case(
            cfg, args.batch, args.seq, args.seed, getattr(torch, args.dtype),
            dev)
        names = ("pod", "data", "model")[-len(args.mesh):]
        mesh = build_mesh(MeshSpec(tuple(args.mesh), names), dev)
        rec = run_steps(cfg, params, opt_state, batch, args.steps, args.lr,
                        mesh, args.strategy, args.microbatches)
        errs = [None] * world
        dist.all_gather_object(errs, rec.pop("shard_errors"))
        if rank == 0:
            rec["shard_errors"] = errs
            torch.save(rec, out_path)
    finally:
        dist.destroy_process_group()


def _config(args):
    cfg = get_config(args.arch)
    return cfg.reduced() if args.reduced else cfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mesh", default="2,2",
                    help="mesh shape: data,model or pod,data,model")
    ap.add_argument("--strategy", default="fsdp2d")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--device", default=None,
                    help="cpu (gloo) or, by default, the cards (NCCL)")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    args.mesh = [int(x) for x in args.mesh.split(",")]
    args.device = resolve_device(args.device).type
    cfg = _config(args)
    dev = torch.device("cuda:0" if args.device == "cuda" else "cpu")
    params, opt_state, batch = make_case(cfg, args.batch, args.seq,
                                         args.seed,
                                         getattr(torch, args.dtype), dev)
    plain = run_steps(cfg, params, opt_state, batch, args.steps, args.lr,
                      microbatches=args.microbatches)
    del params, opt_state
    with tempfile.TemporaryDirectory() as tmp:
        part = os.path.join(tmp, "sharded.pt")
        torch.multiprocessing.spawn(
            _rank_main, args=(args, os.path.join(tmp, "store"), part),
            nprocs=int(np.prod(args.mesh)), join=True)
        sharded = torch.load(part, weights_only=False)
    torch.save({"plain": plain, "sharded": sharded,
                "config": vars(args)}, args.out)
    print(f"[sharded] {args.arch} mesh={args.mesh}: plain loss "
          f"{plain['loss']} sharded loss {sharded['loss']}", flush=True)


if __name__ == "__main__":
    main()
