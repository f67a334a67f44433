"""The layout of the sharded train step (``tdr``'s ``shard_train_state``
path, ``tdr/train/contrastive.py:103-161``).

``tdr`` annotates the encoder's parameters with ``nn.with_partitioning``
(``tdr/models/encoder.py``) and lets XLA partition one jitted step.  The
port writes out what XLA computes, Megatron-style, on the single-controller
mesh of ``tdr_torch.parallel.mesh``:

* every shard (d, m) of the ("data", "model") mesh holds its slice of each
  parameter on its device (``PARAM_SPLITS``: attention heads and the MLP's
  hidden axis over "model", everything else replicated);
* data shard d encodes its rows of the batch with
  ``models.encoder.encode_shards`` over its row of model shards, the
  encoder's one forward;
* after the backward a model-split slice's gradient is summed over "data",
  a replicated parameter's over every shard, in shard order, and every
  replica takes the same sum, so the replicas stay bit-equal.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from tdr_torch.models.encoder import DualEncoder
from tdr_torch.parallel.mesh import Mesh, _copy, psum
from tdr_torch.utils.config import DenseConfig

Spec = Tuple[Optional[str], ...]
Params = Dict[str, torch.Tensor]

# DualEncoder parameter name suffix -> the torch tensor's "model" split
# (an nn.Linear weight is (out, in): flax's (in, out) spec reversed).  The
# rest replicate, as flax's partition specs say: embeddings, LayerNorms,
# the q/k/v biases (flax's attention leaves them unannotated), the output
# and mlp.down biases.
PARAM_SPLITS: Dict[str, Spec] = {
    "attn.query.weight": ("model", None),
    "attn.key.weight": ("model", None),
    "attn.value.weight": ("model", None),
    "attn.out.weight": (None, "model"),
    "mlp.up.weight": ("model", None),
    "mlp.up.bias": ("model",),
    "mlp.down.weight": (None, "model"),
}


def param_spec(name: str, ndim: int) -> Spec:
    for suffix, spec in PARAM_SPLITS.items():
        if name.endswith(suffix):
            return spec
    return (None,) * ndim


def shard_slice(x: torch.Tensor, spec: Spec, m: int, n: int) -> torch.Tensor:
    """Model shard ``m``'s block of ``x`` under ``spec`` (a view)."""
    if "model" not in spec:
        return x
    dim = spec.index("model")
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of size {x.shape[dim]} does not "
                         f"split over {n} model shards")
    return torch.chunk(x, n, dim=dim)[m]


def join_slices(blocks: Sequence[torch.Tensor], spec: Spec) -> torch.Tensor:
    """The inverse of ``shard_slice`` over every model shard."""
    if "model" not in spec:
        return blocks[0]
    dev = blocks[0].device
    return torch.cat([_copy(b, dev) for b in blocks], dim=spec.index("model"))


def reduce_grads(mesh: Mesh, params: List[List[Params]],
                 specs: Dict[str, Spec]) -> None:
    """Replace every shard's gradients by their sum: a model-split slice's
    over "data", a replicated parameter's over every shard (row-major
    order).  Each replica gets the same sum."""
    n_data, n_model = mesh.devices.shape
    for name, spec in specs.items():
        groups = ([[(d, m) for d in range(n_data)] for m in range(n_model)]
                  if "model" in spec else
                  [[(d, m) for d in range(n_data) for m in range(n_model)]])
        for group in groups:
            grads = [params[d][m][name].grad for d, m in group
                     if params[d][m][name].grad is not None]
            if not grads:
                continue
            total = psum(grads, mesh.devices[group[0]])
            for d, m in group:
                params[d][m][name].grad = _copy(total, mesh.devices[d, m])


def train_state_layout(cfg: DenseConfig, mesh: Mesh) -> Dict[str, int]:
    """Bytes each device holds for a sharded train state of ``cfg``: every
    shard's f32 parameter slices and their two AdamW moments, by
    ``str(device)`` (a repeated device holds the sum of its shards)."""
    n_model = mesh.devices.shape[1]
    with torch.device("meta"):
        shapes = {k: p.shape for k, p in DualEncoder(cfg).named_parameters()}
    per_shard = 0
    for name, shape in shapes.items():
        numel = shape.numel()
        if "model" in param_spec(name, len(shape)):
            numel //= n_model
        per_shard += 3 * 4 * numel
    out: Dict[str, int] = {}
    for dev in mesh.devices.flat:
        out[str(dev)] = out.get(str(dev), 0) + per_shard
    return out
