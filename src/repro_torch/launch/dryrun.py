"""The multi-pod dry-run, as `repro.launch.dryrun` has it, on DTensor.

For an (architecture x input shape) cell, the step runs once on the
production mesh — (16, 16) single-pod or (2, 16, 16) multi-pod — and the
run records per device: the bytes of its arguments, the FLOPs of its
matrix products and the bytes and count of the collectives DTensor
issued. The reference lowers and compiles the step under `jax.jit`
with `in_shardings` over fake devices; here the same step runs eagerly
on DTensors whose local shards live on the `meta` device, over a fake
process group of the mesh's size. It is the port's counterpart of a
compile and runs on no device: not a step on the CPU. Every op of the
step runs, so a count covers every call of the layer loop, the
micro-batch loop and the remat recompute: no trip-count correction is
needed.

What is counted, and how:

  * `memory.argument_bytes`: params, optimizer state, batch and cache at
    their local shard shapes (exact: DTensor holds one rank's shard);
  * `cost.flops`: the FLOPs of the matrix products (`mm`, `bmm`, ...,
    as `torch.utils.flop_counter` counts them) that rank 0 runs on its
    local shards — per device, not the global count divided (a
    `FlopCounterMode` wrapped around DTensor code counts the global
    products);
  * `collectives`: the result bytes and the count of each functional
    collective DTensor issued on the local shards, by type;
  * `memory.temp_bytes`: `MemTracker`'s peak of the local tensors the
    step allocates (activations, gradients, temporaries and the new
    state, which the step does not donate) on top of the arguments. No
    compiler plans these buffers, so it is eager PyTorch's peak, not
    XLA's `temp_size_in_bytes`.

The mesh is labelled `cuda` (`dryrun_mesh`), so DTensor takes the
collectives NCCL would: an all-to-all where a mesh labelled `cpu` takes
an all-gather of the whole tensor and a chunk. The label touches no
card; every shard is on `meta`.
A decode cell's `cache_index` is the last position of its cache (a meta
scalar has no value to index with). The attention runs `impl="naive"`
by default: the chunked path (the reference's) runs the same matrix
products block by block, 2,048 blocks a layer at 32k, each block's ops
dispatched on their own, which an eager dry-run cannot afford at full
width. Its collectives and temp bytes differ from the naive path's (the
naive path holds whole score matrices); `--impl chunked` runs it.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun                # all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
      --shape train_4k --single-pod --strategy fsdp2d
  PYTHONPATH=src python -m repro_torch.launch.dryrun --list

Each cell runs in a process of its own (`--jobs` at a time); its
artifact is cached in artifacts/dryrun_torch/<cell>.json and re-runs skip
completed cells (--force to recompute).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import torch

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCHS, cell_is_runnable
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import production_spec
from repro_torch.launch.steps import step_for_shape
from repro_torch.tree import leaves

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun_torch")

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "permute")
#: functional collective -> the reference's HLO name for it
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "permute",
}
TEMP_BYTES_METHOD = (
    "MemTracker's peak over the step of the local (meta) tensors the step "
    "allocates: activations, gradients, temporaries and the new state "
    "(the step does not donate); the arguments are not in it. Eager "
    "frees, not a compiler's buffer plan, set it")


def cell_id(arch: str, shape: str, multi_pod: bool, strategy: str) -> str:
    pod = "pod2" if multi_pod else "pod1"
    return f"{arch}__{shape}__{pod}__{strategy}".replace("/", "_")


class StepCounter:
    """Counts the FLOPs of the matrix products and the collectives that
    run on local shards (rank 0's) while it is entered. DTensor-level
    ops pass through to DTensor, whose local ops come back here;
    DTensor's own shape propagation (on fake tensors) is not counted."""

    def __init__(self):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry
        counter = self
        self.flops = 0
        self.bytes = dict.fromkeys(COLLECTIVES, 0)
        self.count = dict.fromkeys(COLLECTIVES, 0)

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                out = func(*args, **kwargs)
                if any(issubclass(t, FakeTensor) for t in types):
                    return out
                packet = func._overloadpacket
                kind = _COLLECTIVE_OPS.get(packet.__name__)
                if kind is not None:
                    counter.bytes[kind] += sum(
                        t.numel() * t.element_size() for t in leaves(out)
                        if isinstance(t, torch.Tensor))
                    counter.count[kind] += 1
                elif packet in flop_registry:
                    counter.flops += flop_registry[packet](
                        *args, **kwargs, out_val=out)
                return out

        self.mode = Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)

    def collectives(self) -> dict:
        return {"bytes": dict(self.bytes), "count": dict(self.count),
                "total_bytes": sum(self.bytes.values())}


def ensure_fake_group(world_size: int) -> None:
    """A fake process group of `world_size` ranks, this process rank 0:
    collectives return tensors of the right shapes and move nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def dryrun_mesh(spec):
    """A DeviceMesh of `spec`'s shape over the fake group, labelled
    `cuda` so that DTensor picks NCCL's collectives (no card is used:
    the shards are meta tensors)."""
    from torch.distributed.device_mesh import DeviceMesh
    ranks = torch.arange(spec.size).reshape(spec.sizes)
    return DeviceMesh("cuda", ranks, mesh_dim_names=spec.axis_names)


def local_bytes(tree) -> int:
    """Bytes of this rank's shards of a tree of DTensors."""
    return sum(t.to_local().numel() * t.element_size()
               for t in leaves(tree) if t is not None)


def run_step(cfg, shape, mesh, strategy: str = "fsdp2d",
             impl: str = "naive", microbatches: int | None = None) -> dict:
    """The cell's step once on `mesh` (a DeviceMesh over a process group
    that is up) from meta arguments placed by the strategy; returns the
    per-device counts."""
    strat = shd.make_strategy(strategy, mesh)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    n_data = sizes.get("pod", 1) * sizes["data"]
    step, args, names = step_for_shape(cfg, shape, impl=impl, n_data=n_data,
                                       microbatches=microbatches)
    placed = [shd.distribute(a, s) for a, s in
              zip(args, shd.arg_shardings(strat, mesh, names, args))]
    by_arg = {n: local_bytes(a) for n, a in zip(names, placed)}
    if "cache" in names:
        placed[-1] = dict(placed[-1], cache_index=shape.seq_len - 1)
    from torch.distributed._tools.mem_tracker import MemTracker
    tracker = MemTracker()
    with tracker, shd.use_strategy(strat, mesh), StepCounter() as counter:
        step(*placed)
    peak = tracker.get_tracker_snapshot("peak")
    return {"memory": {"argument_bytes": sum(by_arg.values()),
                       "argument_bytes_by_arg": by_arg,
                       "temp_bytes": sum(d["Total"] for d in peak.values()),
                       "temp_bytes_method": TEMP_BYTES_METHOD},
            "cost": {"flops": counter.flops,
                     "flops_method": "local matrix-product FLOPs of rank 0"},
            "collectives": counter.collectives()}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             strategy: str = "fsdp2d", impl: str = "naive",
             save: bool = True, verbose: bool = True,
             artifact_dir: str = ARTIFACT_DIR) -> dict:
    cfg = ARCHS[arch]
    shape = SHAPES[shape_name]
    ok, reason = cell_is_runnable(cfg, shape)
    spec = production_spec(multi_pod)
    rec = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
           "strategy": strategy, "impl": impl, "mesh": list(spec.sizes),
           "kind": shape.kind, "seq_len": shape.seq_len,
           "global_batch": shape.global_batch,
           "param_count": cfg.param_count(),
           "active_param_count": cfg.active_param_count()}
    if not ok:
        rec.update(status="skipped", reason=reason)
        return _finish(rec, save, verbose, artifact_dir)
    t0 = time.time()
    try:
        ensure_fake_group(spec.size)
        mesh = dryrun_mesh(spec)
        rec.update(run_step(cfg, shape, mesh, strategy, impl))
        rec.update(status="ok", run_s=time.time() - t0)
    except Exception as e:       # noqa: BLE001 — record the failure
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:],
                   run_s=time.time() - t0)
    return _finish(rec, save, verbose, artifact_dir)


def artifact_path(arch, shape, multi_pod, strategy,
                  artifact_dir: str = ARTIFACT_DIR) -> str:
    return os.path.join(artifact_dir,
                        cell_id(arch, shape, multi_pod, strategy) + ".json")


def _finish(rec: dict, save: bool, verbose: bool, artifact_dir: str) -> dict:
    if save:
        os.makedirs(artifact_dir, exist_ok=True)
        path = artifact_path(rec["arch"], rec["shape"], rec["multi_pod"],
                             rec["strategy"], artifact_dir)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(rec, f, indent=1)
        os.replace(tmp, path)
    if verbose:
        print(f"[dryrun] {summary(rec)}", flush=True)
    return rec


def summary(rec: dict) -> str:
    status = rec["status"]
    extra = ""
    if status == "ok":
        arg_gb = rec["memory"]["argument_bytes"] / 2**30
        tmp_gb = rec["memory"]["temp_bytes"] / 2**30
        extra = (f" args/dev={arg_gb:.2f}GiB temp/dev={tmp_gb:.2f}GiB"
                 f" flops/dev={rec['cost']['flops']:.3g}"
                 f" coll/dev={rec['collectives']['total_bytes']/2**30:.2f}GiB"
                 f" run={rec['run_s']:.1f}s")
    elif status == "error":
        extra = " " + rec["error"][:160]
    elif status == "skipped":
        extra = " " + rec["reason"]
    cid = cell_id(rec["arch"], rec["shape"], rec["multi_pod"],
                  rec["strategy"])
    return f"{cid}: {status}{extra}"


def _run_in_child(arch, shape, multi_pod, strategy, impl, timeout,
                  artifact_dir):
    """One cell in a process of its own (its own fake group)."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           arch, "--shape", shape, "--strategy", strategy, "--impl", impl,
           "--multi-pod" if multi_pod else "--single-pod", "--force",
           "--in-process", "--artifact-dir", artifact_dir]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout)
    except subprocess.TimeoutExpired:
        # recorded as the cell's failure, as an exception inside it is
        shape_cfg = SHAPES[shape]
        rec = {"arch": arch, "shape": shape, "multi_pod": multi_pod,
               "strategy": strategy, "impl": impl,
               "kind": shape_cfg.kind, "status": "error",
               "error": f"TimeoutExpired: the cell ran past {timeout:.0f} s",
               "run_s": timeout}
        return "[dryrun] " + summary(_finish(rec, True, False, artifact_dir))
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("[dryrun]")]
    if proc.returncode != 0:
        lines.append(f"[dryrun] {cell_id(arch, shape, multi_pod, strategy)}"
                     f": process exited {proc.returncode}: "
                     f"{proc.stderr[-400:]}")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--strategy", default="fsdp2d")
    ap.add_argument("--impl", default="naive")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in its own process")
    ap.add_argument("--timeout", type=float, default=3600.0,
                    help="seconds a cell's process may take")
    ap.add_argument("--in-process", action="store_true",
                    help="run the (single) cell in this process")
    ap.add_argument("--artifact-dir", default=ARTIFACT_DIR)
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    pods = [False, True]
    if args.multi_pod and not args.single_pod:
        pods = [True]
    if args.single_pod and not args.multi_pod:
        pods = [False]

    if args.list:
        for a in archs:
            for s in shapes:
                ok, reason = cell_is_runnable(ARCHS[a], SHAPES[s])
                print(a, s, "runnable" if ok else f"SKIP ({reason})")
        return
    if args.in_process:
        for mp in pods:
            for a in archs:
                for s in shapes:
                    run_cell(a, s, mp, args.strategy, impl=args.impl,
                             artifact_dir=args.artifact_dir)
        return

    t0 = time.time()
    todo = []
    for mp in pods:
        for a in archs:
            for s in shapes:
                path = artifact_path(a, s, mp, args.strategy,
                                     args.artifact_dir)
                if os.path.exists(path) and not args.force:
                    with open(path) as f:
                        prev = json.load(f)
                    if prev.get("status") in ("ok", "skipped"):
                        print(f"[dryrun] cached: {os.path.basename(path)}"
                              f" ({prev['status']})", flush=True)
                        continue
                todo.append((a, s, mp))
    with ThreadPoolExecutor(max(1, args.jobs)) as pool:
        futs = [pool.submit(_run_in_child, a, s, mp, args.strategy,
                            args.impl, args.timeout, args.artifact_dir)
                for a, s, mp in todo]
        for fut in futs:
            print(fut.result(), flush=True)
    print(f"[dryrun] finished {len(todo)} cells in {time.time() - t0:.0f}s",
          flush=True)


if __name__ == "__main__":
    main()
