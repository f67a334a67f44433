"""Full IEEE f32 for the port's f32 products, whatever the caller set.

A float32 product on the card follows torch's process-wide matmul
precision.  ``torch.set_float32_matmul_precision("high")`` (or the older
``torch.backends.cuda.matmul.allow_tf32 = True``, or the newer
``torch.backends.cuda.matmul.fp32_precision = "tf32"``) sends it to the
tensor cores in TF32, which keeps 10 of f32's 23 mantissa bits: an "exact"
rescore is then exact no more.  ``ieee_f32()`` pins full f32 for the body
of a ``with`` (or of a decorated function) and then puts back exactly what
the caller had: the legacy precision string, and the per-backend
``fp32_precision`` of the newer API where the installed torch has it.

The setting is process-wide, so the pin is held under one module lock: two
threads of the port never interleave their pins and restores.  A thread
outside the port that changes the precision while a port call is inside
the pin can still turn that product to TF32, and then finds its own change
undone on exit: the port must not share a process with such a thread.
K2's phase-2 rescore (``ops.fused_head``), on every batch of the sparse
path, takes no pin: it is an elementwise product and a sum, which never go
through TF32.

bf16 and int8 products need none of this: bf16 values are exact in TF32,
and ``torch.mm(..., out_dtype=torch.float32)`` and ``torch._int_mm``
accumulate in f32 and int32.  An f64 product never goes through TF32.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Iterator, List, Optional, Tuple

import torch

_LOCK = threading.RLock()          # one pin at a time; re-entered by nesting


def compute_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype of f32 arithmetic on ``x``: f32 for bf16 and f32 inputs
    (f64 stays f64, for the tests)."""
    return torch.promote_types(x.dtype, torch.float32)


@functools.lru_cache(maxsize=None)
def _new_api_knobs() -> Tuple[object, ...]:
    """The newer API's matmul knobs that ``set_float32_matmul_precision``
    also writes (cuBLAS and oneDNN), on a torch that has them."""
    knobs = []
    for backend in (torch.backends.cuda, getattr(torch.backends, "mkldnn", None)):
        matmul = getattr(backend, "matmul", None)
        try:
            matmul.fp32_precision
        except (AttributeError, RuntimeError):
            continue
        knobs.append(matmul)
    return tuple(knobs)


def _saved() -> Tuple[Optional[str], List[Tuple[object, str]]]:
    try:
        legacy = torch.get_float32_matmul_precision()
    except RuntimeError:
        # the two APIs were mixed: torch refuses to read the legacy string
        # back, and the newer knobs alone decide
        legacy = None
    return legacy, [(k, k.fp32_precision) for k in _new_api_knobs()]


def _restore(state: Tuple[Optional[str], List[Tuple[object, str]]]) -> None:
    legacy, knobs = state
    # the legacy setter overwrites the newer knobs: set it first, then them
    if legacy is not None:
        torch.set_float32_matmul_precision(legacy)
    for knob, value in knobs:
        knob.fp32_precision = value


@contextlib.contextmanager
def ieee_f32() -> Iterator[None]:
    """Full IEEE f32 matmuls inside the body; the caller's setting after it,
    on exit by exception too.  Nests; one thread at a time."""
    with _LOCK:
        state = _saved()
        torch.set_float32_matmul_precision("highest")
        try:
            yield
        finally:
            _restore(state)
