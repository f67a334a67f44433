"""Build and bind the port's CUDA kernels (``tdr_torch/csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process, all started together,
for ``sm_90a``; the objects are linked into one shared library with a plain
C interface, loaded with ``ctypes``.  The build happens at first use into
``tdr_torch/csrc/build/`` (listed in ``.gitignore``) and is redone when a
source or a shared header (``hopper.cuh``) is newer than the library.  The
TMA tensor maps are encoded through the runtime's driver entry point, so
the link needs no ``-lcuda``.  Nothing here runs when the module is
imported, so the CPU tests import every module without ``nvcc``.

The library's kernels go to the CUDA runtime's current device, so each
wrapper launches through ``launch``, which enters ``torch.cuda.device`` of
the device it is given (a mesh shard or a pipeline stage on another card).

``launches`` counts, per kernel, the launches the wrappers made through
``launch``.  The f32 bodies of K2 and K3 count under their own names
(``fused_head_f32``, ``fused_flat_f32``); the LayerNorm's two wrappers as
``layer_norm_fwd`` and ``layer_norm_bwd``, one a call (the backward's call
launches its kernel and the reduction of its partial sums); the attention's
as ``attention_fwd`` and ``attention_bwd``, one a call; the AdamW update's
as ``adamw``, one a param group and device.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(SRC_DIR, "build")
SOURCES = ("tail_compact.cu", "fused_head.cu", "fused_flat.cu",
           "head_scores.cu", "layer_norm.cu", "attention.cu", "adamw.cu")
HEADERS = ("hopper.cuh",)     # included by the sources: a change rebuilds all
LIB_PATH = os.path.join(BUILD_DIR, "libtdr_torch_kernels.so")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]

launches: Dict[str, int] = {"tail_compact": 0, "fused_head": 0,
                            "fused_head_f32": 0, "fused_flat": 0,
                            "fused_flat_f32": 0, "head_scores": 0,
                            "layer_norm_fwd": 0, "layer_norm_bwd": 0,
                            "attention_fwd": 0, "attention_bwd": 0,
                            "adamw": 0}
build_log: str = ""
build_seconds: Optional[float] = None

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
_SIGNATURES = {
    "tdr_tail_compact_fused": [_P] * 10 + [_I] * 9 + [_P],
    "tdr_fused_head_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "tdr_fused_head_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "tdr_fused_flat_bf16": [_P, _P, _P, _P, _I, _I, _I, _F, _P],
    "tdr_fused_flat_f32": [_P, _P, _P, _P, _I, _I, _I, _F, _P],
    "tdr_fused_flat_int8": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "tdr_head_scores_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "tdr_head_scores_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "tdr_layer_norm_fwd": [_P, _I, _P, _P, _P, _P, _I, _I, _F, _P],
    "tdr_layer_norm_bwd_blocks": [_I, _I, _P],
    "tdr_layer_norm_bwd": [_P, _P, _I, _P, _P, _P, _P, _I, _P, _P, _I, _I,
                           _P],
    "tdr_attention_fwd": [_P, _P, _P, _LL, _LL, _LL, _P, _P, _P, _I, _I, _I,
                          _I, _F, _P],
    "tdr_attention_bwd": [_P, _P, _P, _P, _LL, _LL, _LL, _P, _P, _P, _P, _P,
                          _P, _I, _I, _I, _I, _F, _P],
    "tdr_adamw_blocks": [_P],
    "tdr_adamw": [_P, _I, _I, _P, _I] + [_F] * 7 + [_P],
}


class KernelError(RuntimeError):
    """A kernel that did not build, link or launch."""


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError("nvcc not found: the CUDA kernels cannot be built")


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    t = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(os.path.join(SRC_DIR, s)) > t
               for s in SOURCES + HEADERS)


def build(force: bool = False) -> str:
    """Compile every source in parallel (``-Xptxas -v`` so the log shows
    registers, shared memory and spills), then link.  Returns the log."""
    global build_log, build_seconds
    if not force and not _stale():
        return build_log
    os.makedirs(BUILD_DIR, exist_ok=True)
    exe = nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in SOURCES:
        obj = os.path.join(BUILD_DIR, src.replace(".cu", ".o"))
        cmd = [exe, *ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-c", os.path.join(SRC_DIR, src), "-o", obj]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = []
    failed = []
    for src, _, p in procs:
        out, _ = p.communicate()
        log.append(f"== {src}\n{out}")
        if p.returncode != 0:
            failed.append(src)
    if failed:
        raise KernelError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    tmp = LIB_PATH + f".tmp{os.getpid()}"
    link = subprocess.run([exe, *ARCH, "-shared", "-o", tmp,
                           *[o for _, o, _ in procs]],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    log.append(f"== link\n{link.stdout}")
    if link.returncode != 0:
        raise KernelError("kernel link failed:\n" + "\n".join(log))
    os.replace(tmp, LIB_PATH)
    build_seconds = time.perf_counter() - t0
    build_log = "\n".join(log)
    return build_log


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            build()
            handle = ctypes.CDLL(LIB_PATH)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise KernelError(f"{name}: kernel launch failed with CUDA error {err}")


def launch(name: str, symbol: str, device, *args) -> None:
    """Calls the library's ``symbol`` with ``args`` and ``device``'s current
    stream, inside ``torch.cuda.device(device)``; raises ``KernelError``
    under ``name`` if it returns an error, and counts one launch of
    ``name``."""
    import torch

    with torch.cuda.device(device):
        err = getattr(lib(), symbol)(
            *args, torch.cuda.current_stream(device).cuda_stream)
    check(err, name)
    launches[name] += 1
