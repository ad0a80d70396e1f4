"""Build and load the hand-written Hopper kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
for ``sm_90a`` into ``build/lib<name>-<hash>.so``, loaded with ``ctypes``.
The hash of the source, and of each ``csrc/`` header it includes with
``#include "..."``, is part of the file name, so an edited kernel or
header is rebuilt and a stale library is never loaded.  The build happens at first
use, inside the call that launches the kernel (``library``), or all at
once in parallel (``build_all``); nothing is compiled when a module is
imported.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises if that is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
KERNELS = ("hessian", "gptq", "w4a16", "w4a8", "contiguous_attention",
           "paged_attention", "paged_write")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: Dict[str, ctypes.CDLL] = {}
_LOCAL_INCLUDE = re.compile(rb'^\s*#include\s+"([^"]+)"', re.MULTILINE)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _lib_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    for header in _LOCAL_INCLUDE.findall(src):
        src += (CSRC_DIR / header.decode()).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def _start_build(name: str) -> subprocess.Popen:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build_all(names: Sequence[str] = KERNELS) -> Dict[str, dict]:
    """Compile every kernel source that has no up-to-date library, one
    ``nvcc`` per source, all started together.  Returns per source the
    build seconds (0 when it was already built) and the compiler output
    (``-Xptxas=-v`` register and shared-memory report).  Raises if any
    build fails."""
    t0 = time.time()
    procs = {n: _start_build(n) for n in names if not _lib_path(n).exists()}
    report = {n: {"seconds": 0.0, "log": ""} for n in names}
    failed = []
    for n, p in procs.items():
        log, _ = p.communicate()
        report[n] = {"seconds": time.time() - t0, "log": log}
        tmp = _lib_path(n).with_suffix(f".{os.getpid()}.tmp")
        if p.returncode != 0:
            failed.append(f"{n}: nvcc exit {p.returncode}\n{log}")
            continue
        os.replace(tmp, _lib_path(n))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


def library(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed.

    ``signatures`` maps each C entry point to its argument types; every
    entry returns an ``int`` error code.  They are set once, when the
    library is loaded, so a launch pays no ctypes set-up."""
    lib = _loaded.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        lib.gptq_cuda_error_string.argtypes = [ctypes.c_int]
        lib.gptq_cuda_error_string.restype = ctypes.c_char_p
        for fn_name, argtypes in signatures.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.gptq_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
