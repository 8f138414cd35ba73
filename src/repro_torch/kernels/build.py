"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each source under ``csrc/`` compiles on first use into
``<checkout>/build/repro_torch/lib<name>-<digest>.so``; the digest covers
the source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source or header never loads a stale library. Sources have a
plain C interface, so a build takes seconds (no PyTorch headers).
``build_all`` starts one ``nvcc`` per source, all at once, and waits for
every one of them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = {"agg_reduce": "agg_reduce.cu", "quantize": "quantize.cu",
           "flash_attention": "flash_attention.cu",
           "flash_attention_wgmma": "flash_attention_wgmma.cu",
           "flash_attention_bwd": "flash_attention_bwd.cu", "rglru_scan": "rglru_scan.cu",
           "rwkv6_scan": "rwkv6_scan.cu", "rwkv6_scan_bwd": "rwkv6_scan_bwd.cu",
           "im2col": "im2col.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin/ on PATH "
                       "or set CUDA_HOME")


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Tuple[float, str]]:
    """Compile every missing library in parallel.

    Returns ``{name: (seconds, nvcc output)}`` for the libraries built by
    this call (``-Xptxas -v`` reports registers, shared memory and spills
    per kernel). Raises with the compiler's output if any build fails.
    """
    todo = [n for n in (names or SOURCES) if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    results, failures = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        results[name] = (time.perf_counter() - t0, log)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return results


def on_device(device, call):
    """``call(stream)`` with CUDA ``device`` current, given its current
    stream as an int: how a wrapper launches a kernel of a loaded library.
    The raw stream handle, and a device switch only where one is needed,
    keep the host's part of a launch to a few microseconds."""
    current = torch.cuda.current_device()
    if device.index is None or device.index == current:
        return call(torch._C._cuda_getCurrentRawStream(current))
    with torch.cuda.device(device.index):
        return call(torch._C._cuda_getCurrentRawStream(device.index))


def load(name: str, entries: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library for kernel source ``name`` (built if missing).

    ``entries`` maps each entry point to its argument types; they are bound
    once, when the library loads, each returning a C int (the cudaError_t
    of its launch). Each library has one wrapper module, which passes its
    own table on every call."""
    if name not in _loaded:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for entry, argtypes in entries.items():
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _loaded[name] = lib
    return _loaded[name]
