"""AdamW as ``torch.optim.AdamW`` computes it, with one hand-written kernel
a param group and device on the card.

``AdamW`` is ``torch.optim.AdamW`` (decoupled decay, torch's per-parameter
state: ``step`` an f32 scalar on the CPU, ``exp_avg``, ``exp_avg_sq``),
and keeps its class name, so the profiler names a step
``Optimizer.step#AdamW.step`` as before.  Parameters on the CPU take
torch's own step, the plain version (the ``foreach`` path).  f32 CUDA
parameters with f32 gradients take the kernel of
``tdr_torch/csrc/adamw.cu``: one launch updates every parameter of a param
group on a device, at the foreach path's rounding points, reading each
value once and writing it once (28 bytes a parameter against the foreach
path's 80).  A CUDA group the kernel does not take raises; nothing falls
back.

The kernel walks a table of chunks in device memory (``chunk_table``): the
data pointers of a parameter and its two moments, the parameter's index
in the launch, a start offset and a length, a row for each ``CHUNK``
elements.  The table is built on the host and copied to the device once,
and kept while the parameters and moments keep their storage.  The
gradients' pointers go with each launch, in the kernel's parameters:
autograd hands back each step's gradients in new storage.  A step then
costs one launch (one for each ``MAX_TENSORS`` parameters) and no copy.
The step's scalars are computed on the host from the step count, as the
foreach path's are: nothing reads the device.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from tdr_torch.ops import cuda_build
from tdr_torch.utils.trace import count

CHUNK = 16384        # elements a table row covers at most: 4 vectors x 256
                     # threads x 4 a thread's turns, a multiple of 4
MAX_TENSORS = 1024   # gradients a launch (csrc/adamw.cu's kMaxTensors)
_UNSUPPORTED = ("amsgrad", "maximize", "capturable", "differentiable",
                "fused")

# device index -> the kernel's persistent grid on that card
_grid: Dict[int, int] = {}

Scalars = Tuple[float, float, float, float, float, float, float]


def chunk_table(numels: Sequence[int], ptrs: Sequence[Sequence[int]],
                chunk: int = CHUNK) -> np.ndarray:
    """The kernel's chunk table, (rows, 6) int64: tensor ``i`` of
    ``numels[i]`` elements, with data pointers ``ptrs[i]`` = (param,
    exp_avg, exp_avg_sq), gets rows (its three pointers, ``i``, start,
    length) that cover its elements [0, numel) in order, each at most
    ``chunk`` long (a multiple of 4, so every row of a 16-byte aligned
    tensor starts aligned); an empty tensor gets none."""
    if chunk < 4 or chunk % 4:
        raise ValueError(f"chunk {chunk}: needs a positive multiple of 4")
    counts = [-(-int(n) // chunk) for n in numels]
    rows = np.empty((sum(counts), 6), np.int64)
    at = 0
    for i, (n, k, ptr) in enumerate(zip(numels, counts, ptrs)):
        if k == 0:
            continue
        part = rows[at:at + k]
        part[:, :3] = ptr
        part[:, 3] = i
        part[:, 4] = np.arange(k, dtype=np.int64) * chunk
        part[:, 5] = chunk
        part[-1, 5] = int(n) - (k - 1) * chunk
        at += k
    return rows


def step_scalars(lr: float, betas: Tuple[float, float], eps: float,
                 weight_decay: float, step: float) -> Scalars:
    """The kernel's scalars for the update numbered ``step`` (1 for the
    first), in double as the foreach path computes them, in the order
    ``tdr_adamw`` takes them: the decay ``1 - lr wd``, the lerp's weight
    ``1 - beta1``, ``beta2``, ``1 - beta2``, the step ``-lr / (1 -
    beta1^t)``, ``sqrt(1 - beta2^t)`` and eps."""
    beta1, beta2 = betas
    bc1 = 1 - beta1 ** step
    bc2 = 1 - beta2 ** step
    return (1 - lr * weight_decay, 1 - beta1, beta2, 1 - beta2,
            -(lr / bc1), math.sqrt(bc2), eps)


def on_card(p: torch.Tensor) -> bool:
    """Whether ``p``'s update takes the kernel: a CUDA tensor."""
    return p.is_cuda


def check_group(group: dict) -> None:
    """Raises ``ValueError`` for a param group whose options the kernel
    does not compute."""
    on = [k for k in _UNSUPPORTED if group.get(k)]
    if on:
        raise ValueError(f"adamw kernel: {on} not supported")
    if not all(isinstance(group[k], (int, float))
               for k in ("lr", "eps", "weight_decay")):
        raise ValueError("adamw kernel: lr, eps and weight_decay must be "
                         "Python numbers")


def check_tensors(p: torch.Tensor, *others: torch.Tensor) -> None:
    """Raises ``ValueError`` unless ``p`` and ``others`` (its gradient and
    moments) are dense, contiguous f32 tensors of one shape on one
    device."""
    for t in (p, *others):
        if t.is_sparse or t.layout != torch.strided:
            raise ValueError("adamw kernel: a sparse tensor")
        if t.dtype != torch.float32:
            raise ValueError(f"adamw kernel: a {t.dtype} tensor, not "
                             f"float32")
        if t.device != p.device or t.shape != p.shape:
            raise ValueError(f"adamw kernel: {tuple(t.shape)} on "
                             f"{t.device} beside {tuple(p.shape)} on "
                             f"{p.device}")
        if not t.is_contiguous():
            raise ValueError("adamw kernel: a non-contiguous tensor")


def _grid_blocks(device: torch.device) -> int:
    if device.index not in _grid:
        import ctypes

        n = ctypes.c_int(0)
        with torch.cuda.device(device):     # asks the current device
            err = cuda_build.lib().tdr_adamw_blocks(ctypes.byref(n))
        cuda_build.check(err, "adamw")
        _grid[device.index] = n.value
    return _grid[device.index]


def upload(rows: np.ndarray, device: torch.device) -> torch.Tensor:
    """The chunk table on ``device``, copied from pinned host memory
    without waiting on the device's stream."""
    return torch.from_numpy(rows).pin_memory().to(device, non_blocking=True)


@torch.library.custom_op("tdr_torch::adamw_", mutates_args=())
def _adamw_op(table: torch.Tensor, n_chunks: int, grads: int,
              n_tensors: int, scalars: List[float]) -> None:
    # the launch as a torch op: the profiler links a kernel to the op around
    # its launch (the step's own range is a user range, which it does not
    # link), so the kernel's time shows under the optimizer's step
    cuda_build.launch("adamw", "tdr_adamw", table.device, table.data_ptr(),
                      n_chunks, _grid_blocks(table.device), grads, n_tensors,
                      *scalars)


def adamw_update(table: torch.Tensor, n_chunks: int,
                 grads: Sequence[torch.Tensor], scalars: Scalars) -> None:
    """One launch of the kernel over ``table``'s ``n_chunks`` rows, on its
    device, whose tensor indices name ``grads`` (at most
    ``MAX_TENSORS``)."""
    ptrs = np.array([g.data_ptr() for g in grads], np.int64)
    _adamw_op(table, n_chunks, ptrs.ctypes.data, len(ptrs), list(scalars))


class AdamW(torch.optim.AdamW):
    """``torch.optim.AdamW``, whose step of CUDA parameters is one kernel
    launch a param group and device (the module's docstring).  While a
    profiler records, each step counts the elements it updated under
    ``adamw.params``, and those the kernel updated under
    ``adamw.params_kernel``.  ``table_builds`` counts the chunk tables
    built and copied to the device."""

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        # (device, each parameter's and its moments' pointers and its size)
        # -> (table, rows, elements): the tables the last step launched over
        self._tables: Dict[tuple, Tuple[torch.Tensor, int, int]] = {}
        self.table_builds = 0

    @torch.no_grad()
    def step(self, closure=None):
        params = [p for g in self.param_groups for p in g["params"]
                  if p.grad is not None]
        if not any(on_card(p) for p in params):
            count("adamw.params", sum(p.numel() for p in params))
            return self._plain_step(closure)
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        tables: Dict[tuple, Tuple[torch.Tensor, int, int]] = {}
        for group in self.param_groups:
            self._kernel_step(group, tables)
        self._tables = tables
        return loss

    def _plain_step(self, closure):
        # torch's step, without the profiler's range and hooks that a plain
        # ``torch.optim.AdamW`` may have wrapped around it: this step's own
        # wrapper has opened them already
        step = torch.optim.AdamW.step
        if getattr(step, "hooked", False):
            step = step.__wrapped__
        return step(self, closure)

    def _kernel_step(self, group: dict,
                     tables: Dict[tuple, Tuple[torch.Tensor, int, int]]
                     ) -> None:
        check_group(group)
        params = [p for p in group["params"] if p.grad is not None]
        for p in params:
            if not on_card(p):
                raise ValueError(f"adamw kernel: a {p.device} parameter "
                                 f"beside CUDA ones")
            state = self.state[p]
            if not state:
                state["step"] = torch.tensor(0.0, dtype=torch.float32)
                state["exp_avg"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
                state["exp_avg_sq"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
        if not params:
            return
        # parameters that skipped a step have their own count, and so their
        # own bias corrections: a launch for each device and count
        counts = torch.stack([self.state[p]["step"] for p in params]).tolist()
        launches: Dict[Tuple[torch.device, float], List[torch.Tensor]] = {}
        for p, t in zip(params, counts):
            launches.setdefault((p.device, t), []).append(p)
        for (device, t), ps in launches.items():
            torch._foreach_add_([self.state[p]["step"] for p in ps], 1.0)
            scalars = step_scalars(group["lr"], group["betas"], group["eps"],
                                   group["weight_decay"], t + 1)
            for i in range(0, len(ps), MAX_TENSORS):
                self._launch(ps[i:i + MAX_TENSORS], device, scalars, tables)

    def _launch(self, ps: List[torch.Tensor], device: torch.device,
                scalars: Scalars,
                tables: Dict[tuple, Tuple[torch.Tensor, int, int]]) -> None:
        states = [self.state[p] for p in ps]
        key = (device,) + tuple(
            (p.data_ptr(), s["exp_avg"].data_ptr(),
             s["exp_avg_sq"].data_ptr(), p.numel())
            for p, s in zip(ps, states))
        entry = self._tables.get(key)
        if entry is None:
            for p, s in zip(ps, states):
                check_tensors(p, s["exp_avg"], s["exp_avg_sq"])
            rows = chunk_table([k[3] for k in key[1:]],
                               [k[:3] for k in key[1:]])
            entry = (upload(rows, device), len(rows),
                     sum(k[3] for k in key[1:]))
            self.table_builds += 1
        tables[key] = entry
        grads = [p.grad for p in ps]
        for p, g in zip(ps, grads):
            check_tensors(p, g)
        table, n_chunks, n = entry
        adamw_update(table, n_chunks, grads, scalars)
        count("adamw.params", n)
        count("adamw.params_kernel", n)
