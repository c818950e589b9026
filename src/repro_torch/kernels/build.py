"""Build and load the port's CUDA kernels.

The sources in `repro_torch/csrc/*.cu` have a plain C interface. Each is
compiled by its own `nvcc -c` (all started together), and the objects
are linked into one shared library under `build/repro_torch/` in the
checkout, named by a hash of the sources and flags: the build runs at
first use and again whenever a source changes. The library is loaded
with `ctypes`; the wrappers pass `data_ptr()` pointers and the current
stream as `c_void_p`.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("forest.cu", "template.cu", "flash_attention.cu", "ssd.cu")
#: Headers the sources include: part of the library's hash.
HEADERS = ("mma.cuh", "hopper.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_U64 = ctypes.c_uint64
#: C entry points: name -> argument types. Each returns cudaGetLastError().
SIGNATURES = {
    "forest_sums": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                    _I, _I, _P],
    "criticality_scores": [_P, _P, _I, _I, _I, _I, _P],
    "criticality_scores_long": [_P, _P, _I, _I, _I, _P],
    "criticality_block_static_smem": [],
    # q, k, v, o; bh, hq, rep, lq, lk, d, q_offset, valid_lk, causal,
    # window; scale; bf16, tiling, no-key rows' key tile; stream
    "flash_attention": [_P] * 4 + [_I] * 10 + [_F, _I, _I, _I, _P],
    # x, dt, a, b, c, d, y; batch, L, H, P, N, bf16, na (`ssd.ops.plan`);
    # the row strides of x (batch, step, head), b and c (batch, step);
    # scratch, epoch; stream
    "ssd_scan": [_P] * 7 + [_I] * 7 + [_L] * 7 + [_P, _U64, _P],
}


def nvcc() -> str:
    """Path of the CUDA compiler; raises when the toolkit is absent."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (Path(home) / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build repro_torch's kernels")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile the sources (in parallel) and link the library unless it
    is already built. Returns ``{"path", "seconds", "log"}``; `log` holds
    nvcc's output (`-Xptxas -v`: registers, shared memory, spills), kept
    beside the library for later calls."""
    lib = library_path()
    log_file = lib.with_suffix(".log")
    if lib.exists():
        log = log_file.read_text() if log_file.exists() else ""
        return {"path": str(lib), "seconds": 0.0, "log": log}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    cc = nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{Path(s).stem}.o" for s in SOURCES]
        procs = [subprocess.Popen(
            [cc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", str(o)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]
        for s, p, log in zip(SOURCES, procs, logs):
            if p.returncode:
                raise RuntimeError(f"nvcc failed on {s}:\n{log}")
        part = Path(tmp) / lib.name
        link = subprocess.run(
            [cc, *NVCC_FLAGS[:2], "-shared", *map(str, objs), "-o",
             str(part)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        log = "".join(logs) + link.stdout
        log_file.write_text(log)
        os.replace(part, lib)           # atomic: concurrent builds agree
    return {"path": str(lib), "seconds": time.perf_counter() - t0,
            "log": log}


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The built library with every entry point's signature declared."""
    lib = ctypes.CDLL(build()["path"])
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def aligned(t):
    """`t` contiguous with its data at a 16-byte boundary, as the
    kernels' 16-byte copies need (a copy only when it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def launch(name: str, t, *args) -> None:
    """Call entry point `name` with `args` and the current stream of the
    device `t` lies on, with that device current; raise on a launch
    error. The raw stream handle is read as Triton's launcher reads it,
    without building a `torch.cuda.Stream` object on every call."""
    fn = getattr(load(), name)
    dev = t.device.index
    here = torch.cuda.current_device()
    if dev is None or dev == here:
        err = fn(*args, torch._C._cuda_getCurrentRawStream(here))
    else:
        with torch.cuda.device(dev):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    check(err, name)


def check(err: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
