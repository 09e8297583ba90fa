"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` are compiled for Hopper (``sm_90a``) into one
shared library with a plain C interface, loaded with ``ctypes``.  Each
``.cu`` file is compiled by its own ``nvcc`` process, all started together,
and the objects are linked into ``libreprotorch.so``.  The library lands in
``build/repro_torch_kernels/<hash>/`` at the repository root, where
``<hash>`` is a digest of the sources: a change to any source builds anew,
and an unchanged tree reuses the library.  Nothing is built when a module is
imported; ``library()`` builds at first use.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

# the C entry points' dtype code of a key: its size in bytes
KEY_CODES = {torch.int16: 2, torch.int32: 4, torch.int64: 8}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_PP = ctypes.POINTER(ctypes.c_void_p)
SIGNATURES = {
    "rt_smem_block": [],
    "rt_merge_span": [],
    "rt_sort_tiles": [_I, _P, _P, _P, _P, _L, _I, _P],
    "rt_merge_pairs": [_I, _P, _P, _P, _P, _L, _L, _P, _P],
    "rt_unique_mask": [_I, _P, _P, _L, _I, _P],
    "rt_probe_sorted": [_I, _P, _P, _P, _L, _L, _P],
    "rt_while_graph_create": [_P, _P, _PP, _PP],
    "rt_graph_launch": [_P, _P],
    "rt_graph_destroy": [_P, _P],
}

_LIB = None
BUILD_SECONDS = None     # wall time of the build this process ran, if any


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256()
    for f in sum(_sources(), []):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin or "
                       "/usr/local/cuda/bin): the port's kernels are built "
                       "from source on the machine with the card")


def build(out_dir: Path) -> Path:
    """Compile every source in parallel and link the shared library into
    ``out_dir``; returns its path.  Raises with nvcc's output on failure."""
    nvcc = _nvcc()
    cus, _ = _sources()
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir.parent) as tmp:
        procs = []
        for cu in cus:
            obj = Path(tmp) / (cu.stem + ".o")
            cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", str(cu), "-o",
                   str(obj)]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for cmd, _, p in procs:
            out, _ = p.communicate()
            if p.returncode:
                failed.append(f"{' '.join(cmd)}\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        so_tmp = Path(tmp) / "libreprotorch.so"
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(so_tmp),
                *(str(obj) for _, obj, _ in procs)]
        res = subprocess.run(link, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc link failed:\n{' '.join(link)}\n"
                               f"{res.stdout}")
        so = out_dir / "libreprotorch.so"
        os.replace(so_tmp, so)    # atomic: a reader never sees half a file
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built from the sources at first use."""
    global _LIB, BUILD_SECONDS
    if _LIB is None:
        out_dir = BUILD_ROOT / _digest()
        so = out_dir / "libreprotorch.so"
        if not so.exists():
            t0 = time.perf_counter()
            build(out_dir)
            BUILD_SECONDS = time.perf_counter() - t0
        lib = ctypes.CDLL(str(so))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.rt_error_string.argtypes = [ctypes.c_int]
        lib.rt_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def launch(entry: str, device: torch.device, *args) -> None:
    """Call the C entry point ``entry`` with ``args`` and the current CUDA
    stream of ``device``; raise if it reports a CUDA error (a launch that
    was refused never runs, and no later synchronize would say so)."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(*args, stream)
    if err:
        msg = lib.rt_error_string(err).decode()
        raise RuntimeError(f"{entry}: CUDA error {err} ({msg})")
