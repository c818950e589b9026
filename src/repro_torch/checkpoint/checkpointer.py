"""Atomic checkpointing, as `repro.checkpoint.checkpointer` has it, in
the same layout, so a checkpoint written by either package restores in
the other:

    <dir>/step_<N>/
        meta.json     — step, and for each flat key its numpy dtype
                        string ("bfloat16" for bf16) and shape
        shard_0.npz   — one array a key, the key's "/" written "__";
                        bf16 stored as its uint16 bits
        COMMIT        — written last; a step without it is ignored

A flat key joins the tree path's dict keys and sequence indices with
"/", as the reference's does from jax's tree paths. save() writes into
step_<N>.tmp and renames it, so a partial write never hides the newest
committed step; restore() takes the newest committed step unless told
one; keep_last rotates old steps out. Arrays are whole per key, so a
restore may place them anywhere: `restore(..., shardings=)` puts each on
a mesh (`runtime.elastic`).
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from repro_torch.tree import leaves_with_path, unflatten


def _flatten(tree) -> dict:
    return {"/".join(str(k) for k in path): leaf
            for path, leaf in leaves_with_path(tree)}


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, dtype=dtype))
    return t.to(device)


class Checkpointer:
    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)

    # -- save --------------------------------------------------------------
    def save(self, step: int, tree) -> str:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        arrays = {}
        meta = {"step": step, "keys": {}}
        for key, leaf in _flatten(tree).items():
            arr, dtype = _to_numpy(torch.as_tensor(leaf))
            meta["keys"][key] = {"dtype": dtype, "shape": list(arr.shape)}
            arrays[key.replace("/", "__")] = arr
        np.savez(os.path.join(tmp, "shard_0.npz"), **arrays)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        with open(os.path.join(tmp, "COMMIT"), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._rotate()
        return final

    def _rotate(self):
        steps = self.all_steps()
        for s in steps[:-self.keep_last]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore -----------------------------------------------------------
    def all_steps(self):
        out = []
        for name in sorted(os.listdir(self.dir)):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name, "COMMIT")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like, step: int | None = None, shardings=None):
        """(tree, step): the structure of `tree_like`, each leaf the saved
        array in its saved dtype on the device of `tree_like`'s leaf. With
        `shardings` (a tree like it of `launch.sharding.NamedSharding`)
        each leaf is placed on its sharding's mesh as a DTensor instead:
        the arrays are whole, so any mesh takes them."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in "
                                    f"{self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        like = _flatten(tree_like)
        with np.load(os.path.join(d, "shard_0.npz")) as data:
            out = [_from_numpy(data[key.replace("/", "__")],
                               meta["keys"][key]["dtype"],
                               torch.as_tensor(leaf).device)
                   for key, leaf in like.items()]
        tree = unflatten(tree_like, out)
        if shardings is not None:
            from repro_torch.launch.sharding import distribute
            tree = distribute(tree, shardings)
        return tree, step
