"""Document-sharded dense flat search (from ``tdr/parallel/dense.py``).

The (N, D) embedding matrix is split into contiguous row ranges, one per
data device; each device takes one (Q, D) x (D, N_loc) product and a local
top-k, and the merge gathers the S·k candidates.  The document axis is the
product's output axis, so each shard's scores are the single-device
product's: only the merge is new.  ``tdr`` takes this product with
``jnp.dot`` outside any Pallas kernel, so here it is the library product
(``models.dense._plain_scores``: bf16 with f32 output, f32 in IEEE f32,
int8 x int8 -> int32 with per-query and per-document scales), not K3.

Dtypes bf16, f32 and int8 (SQ8, per document row; the scales shard with
the rows); metrics "ip" and "l2".  ``approx=True`` takes the exact top-k,
as the port does for ``approx_max_k`` everywhere.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tdr_torch.models.dense import (NEG_INF, FlatIndex, _plain_scores,
                                    _round_up, _sq8_quantize)
from tdr_torch.ops.topk import fast_topk, merge_gathered_topk
from tdr_torch.parallel.mesh import Mesh, _copy, all_gather, psum
from tdr_torch.parallel.sharded import _rows_to_docs, _shard_bounds
from tdr_torch.utils.device import DeviceLike, resolve_device


@dataclass
class ShardedFlatIndex:
    """One padded (N_loc_pad, D) block per shard, shard s on its device:
    ``embeddings[s]``, with ``doc_sq[s]`` (l2) and ``doc_scale[s]`` (int8)
    beside it."""

    embeddings: List[torch.Tensor]
    doc_sq: Optional[List[torch.Tensor]] = None
    doc_scale: Optional[List[torch.Tensor]] = None
    n_valid: Optional[torch.Tensor] = None     # (S,) int32 on the host
    n_shards: int = 1
    n_docs: int = 0
    n_loc_pad: int = 0
    metric: str = "ip"

    def shard(self, s: int) -> FlatIndex:
        """Shard ``s`` as a single-device ``FlatIndex`` of its local rows."""
        return FlatIndex(
            embeddings=self.embeddings[s],
            doc_sq=None if self.doc_sq is None else self.doc_sq[s],
            doc_scale=None if self.doc_scale is None else self.doc_scale[s],
            n_docs=int(self.n_valid[s]), metric=self.metric)


def build_sharded_flat_index(embeddings, n_shards: int,
                             pad_multiple: int = 128, metric: str = "ip",
                             dtype: str = "bfloat16",
                             devices: Optional[Sequence[DeviceLike]] = None
                             ) -> ShardedFlatIndex:
    """Partition (n, D) embeddings (numpy or a tensor) into ``n_shards``
    contiguous row ranges padded to one local length, shard s on
    ``devices[s]`` (default: the ``resolve_device`` rule).  bf16 and f32
    are stored as such; int8 quantizes each document row on the host (as
    ``build_flat_index`` does).  For l2, ‖d‖² in f64 rounded to f32;
    padding rows +inf."""
    if metric not in ("ip", "l2") or dtype not in ("bfloat16", "float32",
                                                   "int8"):
        raise ValueError(f"sharded flat index: metric {metric!r}, dtype "
                         f"{dtype!r}")
    src = torch.as_tensor(embeddings)
    n, d = src.shape
    bounds = _shard_bounds(n, n_shards)
    n_local = np.diff(bounds)
    n_loc_pad = max(_round_up(max(int(n_local.max()) if n else 1, 1),
                              pad_multiple), pad_multiple)
    devs = ([resolve_device(None)] * n_shards if devices is None
            else [resolve_device(devices[s % len(devices)])
                  for s in range(n_shards)])
    emb, sqs, scales = [], [], []
    for s, dev in enumerate(devs):
        blk = src[bounds[s]:bounds[s + 1]].to(
            dev if dtype != "int8" else "cpu", torch.float32)
        e = torch.zeros((n_loc_pad, d), dtype=torch.float32, device=blk.device)
        e[:n_local[s]] = blk
        if metric == "l2":
            sq = torch.full((n_loc_pad,), float("inf"), dtype=torch.float32,
                            device=blk.device)
            sq[:n_local[s]] = (blk.double() ** 2).sum(dim=1).float()
            sqs.append(sq.to(dev))
        if dtype == "int8":
            e8, scale = _sq8_quantize(e.numpy(), axis=1)
            emb.append(torch.from_numpy(e8).to(dev))
            scales.append(torch.from_numpy(scale).to(dev))
        else:
            emb.append(e.to(torch.bfloat16) if dtype == "bfloat16" else e)
    return ShardedFlatIndex(
        embeddings=emb, doc_sq=sqs or None, doc_scale=scales or None,
        n_valid=torch.as_tensor(n_local, dtype=torch.int32),
        n_shards=n_shards, n_docs=n, n_loc_pad=n_loc_pad, metric=metric)


def sharded_flat_search(mesh: Mesh, sindex: ShardedFlatIndex,
                        q: torch.Tensor, top_k: int = 10,
                        approx: bool = False, recall_target: float = 0.95
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, D) replicated queries against the doc-sharded matrix: per
    device one product and a local top-k, then a gather to the mesh's first
    device and a global top-k.  Returns (vals (Q, k), GLOBAL rows (Q, k));
    ``sharded_row_to_doc`` maps rows to corpus rows.  ``approx`` and
    ``recall_target`` are accepted for ``tdr``'s signature: the top-k is
    exact either way."""
    devs = mesh.axis_devices("data")
    if len(devs) != sindex.n_shards:
        raise ValueError(f"{sindex.n_shards} shards on a data axis of "
                         f"{len(devs)}")
    k_local = min(top_k, sindex.n_loc_pad)
    vals_l, rows_l = [], []
    for s, dev in enumerate(devs):
        shard = sindex.shard(s)
        dots = _plain_scores(shard, _copy(q, dev))
        scores = (2.0 * dots - shard.doc_sq[None, :] if sindex.metric == "l2"
                  else dots)
        slot = torch.arange(scores.shape[1], device=dev)[None, :]
        scores = torch.where(slot < shard.n_docs, scores,
                             torch.full((), NEG_INF, device=dev))
        v, r = fast_topk(scores, k_local)
        vals_l.append(v)
        rows_l.append(torch.where(torch.isfinite(v), r, torch.zeros_like(r))
                      + s * sindex.n_loc_pad)
    vals, rows = merge_gathered_topk(all_gather(vals_l, mesh.first),
                                     all_gather(rows_l, mesh.first), top_k)
    if sindex.metric == "l2":
        q_sq = (_copy(q, mesh.first).float() ** 2).sum(dim=1, keepdim=True)
        vals = torch.where(torch.isfinite(vals), vals - q_sq, vals)
    return vals, rows


def sharded_flat_search_prf(mesh: Mesh, sindex: ShardedFlatIndex,
                            q: torch.Tensor, top_k: int = 10,
                            n_feedback: int = 3, alpha: float = 0.5,
                            approx: bool = False, recall_target: float = 0.95
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rocchio feedback over the doc-sharded matrix (``flat_search_prf`` on
    a mesh): each device sums the feedback rows it owns (a global row is
    shard·n_loc_pad + local), a ``psum`` merges the partial sums and
    counts, and the refined queries take a second sharded pass."""
    fb_vals, fb_rows = sharded_flat_search(mesh, sindex, q, top_k=n_feedback)
    finite = torch.isfinite(fb_vals)
    n_loc_pad = sindex.n_loc_pad
    parts, counts = [], []
    for s, dev in enumerate(mesh.axis_devices("data")):
        local = _copy(fb_rows, dev) - s * n_loc_pad              # (Q, F)
        mine = (local >= 0) & (local < n_loc_pad) & _copy(finite, dev)
        lsafe = local.clamp(0, n_loc_pad - 1)
        e = sindex.embeddings[s][lsafe].float()                  # (Q, F, D)
        if sindex.doc_scale is not None:
            e = e * sindex.doc_scale[s][lsafe][..., None]
        e = torch.where(mine[..., None], e, torch.zeros((), device=dev))
        parts.append(e.sum(dim=1))
        counts.append(mine.sum(dim=1).float())
    tot, cnt = psum(parts, mesh.first), psum(counts, mesh.first)
    centroid = tot / cnt.clamp_min(1e-9)[:, None]

    qf = _copy(q, mesh.first).float()
    if sindex.metric == "l2":
        q2 = (1.0 - alpha) * qf + alpha * centroid
    else:
        q2 = qf + alpha * centroid
        qn = torch.linalg.vector_norm(qf, dim=1, keepdim=True)
        q2n = torch.linalg.vector_norm(q2, dim=1, keepdim=True).clamp_min(1e-9)
        q2 = q2 * (qn / q2n)
    q2 = torch.where(finite.any(dim=1, keepdim=True), q2, qf)
    return sharded_flat_search(mesh, sindex, q2.to(q.dtype), top_k=top_k)


def sharded_row_to_doc(sindex: ShardedFlatIndex, rows):
    """Map sharded global rows (shard·pad + local) to corpus rows (numpy,
    or a tensor on its own device)."""
    return _rows_to_docs(rows, sindex.n_docs, sindex.n_shards,
                         sindex.n_loc_pad)
