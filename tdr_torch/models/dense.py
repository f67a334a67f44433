"""Dense-embedding retrieval: the port of ``tdr/models/dense.py``.

Brute-force and IVF search over L2-normalized embeddings (inner product ==
cosine, ``faiss.normalize_L2`` + ``IndexFlatIP`` semantics):

* **flat**: the (N_pad, D) embedding matrix on the device; the exact engine
  is the fused block-max kernel (``tdr_torch.ops.fused_flat``), whose (Q, N)
  scores never reach memory; the plain engine is one product plus a stable
  top-k;
* **IVF**: spherical k-means centroids; search probes the ``nprobe``
  nearest clusters through a gather of cluster-bucketed embeddings padded to
  the largest cluster.  Plain torch: ``tdr`` has no kernel here either.

``jax.random`` cannot be reproduced in torch, so the IVF builds take the
k-means initial rows from the caller where a test needs JAX's; without
them (and for the training subsample) they draw from a seeded
``torch.Generator``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from tdr_torch.index.build import _tensor_from_saved
from tdr_torch.models.encoder import encode, module_device
from tdr_torch.ops.fused_flat import (fused_flat_available, fused_flat_topk,
                                      quantize_queries_int8)
from tdr_torch.ops.precision import ieee_f32
from tdr_torch.ops.topk import fast_topk
from tdr_torch.text.hash_tokenizer import encode_batch
from tdr_torch.utils.config import DenseConfig
from tdr_torch.utils.device import DeviceLike, resolve_device

__all__ = [
    "FlatIndex", "IvfIndex", "DenseModel", "build_flat_index",
    "flat_index_from_arrays", "flat_search", "flat_search_prf",
    "build_ivf_index", "build_ivf_index_device", "ivf_index_from_arrays",
    "ivf_search", "evaluate_dense", "quantize_queries_int8",
]

NEG_INF = float("-inf")
_IVF_GATHER_BYTES = 1 << 28      # cap on one query chunk's f32 bucket gather


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _sq8_quantize(x: np.ndarray, axis: int):
    """Symmetric per-slice int8 quantization: ``x ≈ codes * scale`` with
    the scale taken over ``axis`` (rows for flat indexes, the embedding
    dim for IVF bucket entries).  All-zero slices get scale 0 and stay
    exactly zero."""
    vmax = np.abs(x).max(axis=axis, keepdims=True)
    scale = vmax / 127.0
    inv = np.where(scale > 0, 1.0 / np.maximum(scale, 1e-30), 0.0)
    codes = np.rint(x * inv).astype(np.int8)
    return codes, np.squeeze(scale, axis=axis).astype(np.float32)


def _pad_target(n: int, batch: int) -> int:
    """Pad encoder batches to a power of two (min 32, capped at ``batch``) so
    tiny inputs don't pay a full-batch transformer forward."""
    t = 32
    while t < n:
        t <<= 1
    return min(max(t, 32), max(batch, 32))


def _pad_topk(vals: torch.Tensor, rows: torch.Tensor, top_k: int):
    k = vals.shape[1]
    if k < top_k:
        vals = torch.nn.functional.pad(vals, (0, top_k - k), value=NEG_INF)
        rows = torch.nn.functional.pad(rows, (0, top_k - k))
    return vals, rows


# --------------------------------------------------------------------------
# Brute-force flat index
# --------------------------------------------------------------------------

@dataclass
class FlatIndex:
    """Exact flat search: inner product (IndexFlatIP) or unnormalized
    squared L2 (IndexFlatL2).  For l2 the doc squared norms are kept, and
    search ranks by ``2·q·d − ‖d‖²`` (the order of −‖q−d‖²)."""

    embeddings: torch.Tensor                  # (N_pad, D) bf16/f32, or int8
    doc_sq: Optional[torch.Tensor] = None     # (N_pad,) f32 ‖d‖² (l2)
    doc_scale: Optional[torch.Tensor] = None  # (N_pad,) f32 (int8, SQ8)
    n_docs: int = 0
    metric: str = "ip"


def _resolve_flat_engine(index: FlatIndex, top_k: int, approx: bool,
                         engine: str) -> str:
    """"auto" takes the fused kernel for CUDA tensors whose shapes pass the
    gate, the plain path otherwise; "fused" forces the fused engine (on CPU
    tensors its phase 1 is the kernel's plain version); "plain" is the
    product + top-k path.  ``approx`` takes the plain path, whose top-k is
    exact."""
    if engine not in ("auto", "fused", "plain"):
        raise ValueError(f"unknown flat engine {engine!r}")
    if approx or engine == "plain":
        return "plain"
    ok = fused_flat_available(index.embeddings, top_k)
    if engine == "fused":
        if not ok:
            raise ValueError(
                f"fused flat engine unavailable for shape "
                f"{tuple(index.embeddings.shape)} dtype "
                f"{index.embeddings.dtype}")
        return "fused"
    return "fused" if ok and index.embeddings.is_cuda else "plain"


def _int8_dots(q8: torch.Tensor, emb8: torch.Tensor) -> torch.Tensor:
    """Exact int32 products ``q8 · emb8ᵀ``: ``torch._int_mm`` on the card
    (which wants more than 16 rows and multiples of 8), an int32 product on
    the CPU."""
    if not emb8.is_cuda:
        return q8.to(torch.int32) @ emb8.to(torch.int32).T
    Q, D = q8.shape
    N = emb8.shape[0]
    if D % 8 or N % 8:
        raise ValueError(f"int8 flat search needs D and N multiples of 8 "
                         f"(got D={D}, N={N})")
    Qp = max(32, _round_up(Q, 8))
    qp = torch.zeros((Qp, D), dtype=torch.int8, device=q8.device)
    qp[:Q] = q8
    return torch._int_mm(qp, emb8.T)[:Q]


def _plain_scores(index: FlatIndex, q: torch.Tensor) -> torch.Tensor:
    """(Q, N_pad) f32 scores through one product: int8×int8→int32 with the
    scales on the output axes, or the storage dtype with f32 output (f32
    storage in full IEEE f32; bf16 values are exact in TF32 anyway)."""
    emb = index.embeddings
    if emb.dtype == torch.int8:
        q8, qs = quantize_queries_int8(q)
        return _int8_dots(q8, emb).float() * qs * index.doc_scale[None, :]
    qk = q.to(emb.dtype)
    if emb.dtype == torch.float32:
        with ieee_f32():
            return qk @ emb.T
    if emb.is_cuda:
        return torch.mm(qk, emb.T, out_dtype=torch.float32)
    return qk.float() @ emb.float().T        # exact products of bf16 values


def flat_search(index: FlatIndex, q: torch.Tensor, top_k: int = 10,
                approx: bool = False, recall_target: float = 0.95,
                engine: str = "auto"):
    """(Q, D) queries → (vals (Q, top_k) f32, rows (Q, top_k) int64), padded
    with (-inf, 0).

    Metric "ip": vals are inner products, descending.  Metric "l2": vals
    are negated squared L2 distances (nearest first) over the raw
    embeddings.  ``approx=True`` takes the plain path with an exact top-k
    (``tdr``'s ``approx_max_k`` is a TPU custom call), so ``recall_target``
    is accepted for ``tdr``'s signature and ignored.  ``engine`` as in
    ``_resolve_flat_engine``."""
    eng = _resolve_flat_engine(index, top_k, approx, engine)
    if eng == "fused":
        return fused_flat_topk(
            index.embeddings, q, top_k=top_k, metric=index.metric,
            n_docs=index.n_docs, doc_sq=index.doc_sq,
            doc_scale=index.doc_scale)
    dots = _plain_scores(index, q)
    if index.metric == "l2":
        # rank by 2qd − ‖d‖²; add the per-query −‖q‖² afterwards so the
        # returned vals are true −‖q−d‖²
        scores = 2.0 * dots - index.doc_sq[None, :]
    else:
        scores = dots
    doc = torch.arange(scores.shape[1], device=scores.device)[None, :]
    scores = torch.where(doc < index.n_docs, scores,
                         torch.full((), NEG_INF, device=scores.device))
    k = min(top_k, scores.shape[1])
    vals, rows = fast_topk(scores, k)
    if index.metric == "l2":
        q_sq = (q.float() ** 2).sum(dim=1, keepdim=True)
        vals = torch.where(torch.isfinite(vals), vals - q_sq, vals)
    return _pad_topk(vals, rows, top_k)


def flat_search_prf(index: FlatIndex, q: torch.Tensor, top_k: int = 10,
                    n_feedback: int = 3, alpha: float = 0.5,
                    approx: bool = False, recall_target: float = 0.95,
                    engine: str = "auto"):
    """Rocchio pseudo-relevance feedback: first pass top-F, pull the query
    toward the feedback centroid, one second pass.  "ip": the refined query
    is rescaled to the original norm (alpha=0 equals plain flat_search);
    "l2": ``(1-alpha)·q + alpha·centroid``.  Feedback embeddings dequantize
    per doc for int8 indexes.  ``recall_target`` is ignored, as in
    ``flat_search``."""
    fb_vals, fb_rows = flat_search(index, q, top_k=n_feedback, approx=approx,
                                   engine=engine)
    finite = torch.isfinite(fb_vals)
    rows_safe = torch.where(finite, fb_rows, torch.zeros_like(fb_rows))
    emb = index.embeddings[rows_safe].float()                # (Q, F, D)
    if index.embeddings.dtype == torch.int8:
        emb = emb * index.doc_scale[rows_safe][..., None]
    w = finite.float()
    centroid = ((emb * w[..., None]).sum(dim=1)
                / w.sum(dim=1, keepdim=True).clamp_min(1e-9))
    qf = q.float()
    if index.metric == "l2":
        q2 = (1.0 - alpha) * qf + alpha * centroid
    else:
        q2 = qf + alpha * centroid
        qn = torch.linalg.vector_norm(qf, dim=1, keepdim=True)
        q2n = torch.linalg.vector_norm(q2, dim=1, keepdim=True).clamp_min(1e-9)
        q2 = q2 * (qn / q2n)
    # a query with NO finite feedback (empty index slice) keeps itself
    q2 = torch.where(finite.any(dim=1, keepdim=True), q2, qf)
    return flat_search(index, q2.to(q.dtype), top_k=top_k, approx=approx,
                       engine=engine)


def build_flat_index(embeddings, pad_multiple: int = 128, metric: str = "ip",
                     dtype: str = "bfloat16",
                     device: DeviceLike = None) -> FlatIndex:
    """(n, D) embeddings (numpy or a tensor) → a ``FlatIndex`` on
    ``device``, padded to ``pad_multiple`` rows.  ``dtype="bfloat16"``
    (default) or ``"int8"`` (per-doc symmetric scalar quantization, the
    FAISS SQ8 trade; quantized on the host as ``tdr`` does).  For l2, ‖d‖²
    is taken in f64 and rounded to f32; padding rows get +inf."""
    if metric not in ("ip", "l2") or dtype not in ("bfloat16", "int8"):
        raise ValueError(f"flat index: metric {metric!r}, dtype {dtype!r}")
    dev = resolve_device(device)
    src = torch.as_tensor(embeddings)
    src = src.to(dev if dtype == "bfloat16" else "cpu", torch.float32)
    n, d = src.shape
    n_pad = max(_round_up(max(n, 1), pad_multiple), pad_multiple)
    e = torch.zeros((n_pad, d), dtype=torch.float32, device=src.device)
    e[:n] = src
    doc_sq = None
    if metric == "l2":
        sq = torch.full((n_pad,), float("inf"), dtype=torch.float32,
                        device=src.device)
        sq[:n] = (src.double() ** 2).sum(dim=1).float()
        doc_sq = sq.to(dev)
    if dtype == "int8":
        e8, scale = _sq8_quantize(e.numpy(), axis=1)
        return FlatIndex(embeddings=torch.from_numpy(e8).to(dev),
                         doc_sq=doc_sq,
                         doc_scale=torch.from_numpy(scale).to(dev),
                         n_docs=n, metric=metric)
    return FlatIndex(embeddings=e.to(torch.bfloat16), doc_sq=doc_sq,
                     n_docs=n, metric=metric)


def flat_index_from_arrays(arrays: Dict[str, np.ndarray], meta: dict,
                           device: DeviceLike = None) -> FlatIndex:
    """A ``FlatIndex`` from numpy arrays in the layout of a ``tdr`` dense
    checkpoint's ``index.npz`` (``embeddings``, optional ``doc_scale`` and
    ``doc_sq``) and ``meta.json`` (``emb_dtype``, ``n_docs``, ``metric``;
    bf16 arrives as its uint16 bits).  Carries an index built by the JAX
    package across."""
    dev = resolve_device(device)
    opt = {k: _tensor_from_saved(arrays[k], "float32", dev)
           for k in ("doc_scale", "doc_sq") if k in arrays}
    return FlatIndex(
        embeddings=_tensor_from_saved(arrays["embeddings"],
                                      meta.get("emb_dtype", ""), dev),
        n_docs=int(meta["n_docs"]), metric=meta.get("metric", "ip"), **opt)


# --------------------------------------------------------------------------
# IVF (inverted-file) partitioned index
# --------------------------------------------------------------------------

@dataclass
class IvfIndex:
    """k-means partitioned ANN index (IndexIVFFlat equivalent)."""

    centroids: torch.Tensor        # (nlist, D) f32
    buckets: torch.Tensor          # (nlist, bucket_pad, D) f32 or int8 (SQ8)
    bucket_rows: torch.Tensor      # (nlist, bucket_pad) int32 original rows
    bucket_counts: torch.Tensor    # (nlist,) int32
    bucket_scale: Optional[torch.Tensor] = None   # (nlist, bucket_pad) f32
    n_docs: int = 0
    nlist: int = 0
    bucket_pad: int = 0


def _as_rows(rows) -> torch.Tensor:
    return rows.long() if isinstance(rows, torch.Tensor) else torch.tensor(
        np.asarray(rows), dtype=torch.long)


def _choose_rows(n: int, k: int, seed: int) -> torch.Tensor:
    """k distinct rows of n from a seeded generator (``jax.random.choice``
    without replacement, which torch cannot reproduce)."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randperm(n, generator=gen)[:k]


@ieee_f32()
def _kmeans_step(emb: torch.Tensor, cent: torch.Tensor, nlist: int,
                 chunk: int) -> torch.Tensor:
    """One spherical k-means step: assign each row to its max-inner-product
    centroid (in row chunks), sum the rows per centroid, normalize; an empty
    centroid keeps its place."""
    n, d = emb.shape
    sums = torch.zeros((nlist, d), dtype=torch.float32, device=emb.device)
    for s in range(0, n, chunk):
        blk = emb[s:s + chunk].float()
        assign = torch.argmax(blk @ cent.T, dim=1)
        sums.index_add_(0, assign, blk)
    norms = torch.linalg.vector_norm(sums, dim=1, keepdim=True)
    return torch.where(norms > 1e-6, sums / norms.clamp_min(1e-6), cent)


@ieee_f32()
def _assign_chunked(emb: torch.Tensor, cent: torch.Tensor,
                    chunk: int) -> torch.Tensor:
    """argmax_j emb@cent[j] in row chunks: the (N, nlist) similarity never
    materializes."""
    return torch.cat([torch.argmax(emb[s:s + chunk].float() @ cent.T, dim=1)
                      for s in range(0, emb.shape[0], chunk)])


def _kmeans(emb: torch.Tensor, nlist: int, iters: int,
            init_rows: torch.Tensor, chunk: int):
    """Spherical k-means from ``emb[init_rows]``: (centroids, assignments)."""
    cent = emb[init_rows.to(emb.device)].float()
    for _ in range(iters):
        cent = _kmeans_step(emb, cent, nlist, chunk)
    return cent, _assign_chunked(emb, cent, chunk)


def _fill_buckets(assign: np.ndarray, nlist: int):
    """Stable bucket fill: (counts, bucket_pad, rows (nlist, bucket_pad)
    int32), each bucket's rows in ascending order."""
    n = assign.shape[0]
    counts = np.bincount(assign, minlength=nlist)
    bucket_pad = max(8, _round_up(int(counts.max()) if n else 1, 8))
    order = np.argsort(assign, kind="stable").astype(np.int64)
    starts = np.zeros(nlist + 1, np.int64)
    starts[1:] = np.cumsum(counts)
    pos = np.arange(n, dtype=np.int64) - np.repeat(starts[:-1], counts)
    rows = np.zeros((nlist, bucket_pad), np.int32)
    rows[assign[order], pos] = order.astype(np.int32)
    return counts, bucket_pad, rows


def _ivf_from_assignment(emb: torch.Tensor, cent: torch.Tensor,
                         assign: np.ndarray, nlist: int,
                         dtype: str) -> IvfIndex:
    dev = emb.device
    n, d = emb.shape
    counts, bucket_pad, rows = _fill_buckets(assign, nlist)
    rows_t = torch.from_numpy(rows).to(dev)
    counts_t = torch.from_numpy(counts.astype(np.int32)).to(dev)
    gathered = emb[rows_t.long().reshape(-1)].float().reshape(
        nlist, bucket_pad, d)
    slot = torch.arange(bucket_pad, device=dev)[None, :, None]
    gathered = torch.where(slot < counts_t[:, None, None], gathered,
                           torch.zeros((), device=dev))
    scale = None
    if dtype == "int8":
        vmax = gathered.abs().amax(dim=2, keepdim=True)
        sc = vmax / 127.0
        inv = torch.where(sc > 0, 1.0 / sc.clamp_min(1e-30),
                          torch.zeros((), device=dev))
        buckets = torch.round(gathered * inv).to(torch.int8)
        scale = sc[..., 0]
    else:
        buckets = gathered
    return IvfIndex(centroids=cent, buckets=buckets, bucket_rows=rows_t,
                    bucket_counts=counts_t, bucket_scale=scale, n_docs=n,
                    nlist=nlist, bucket_pad=bucket_pad)


def build_ivf_index_device(
    embeddings: torch.Tensor,
    nlist: int = 2048,
    iters: int = 8,
    seed: int = 0,
    dtype: str = "int8",
    train_subsample: Optional[int] = None,
    assign_chunk: Optional[int] = None,
    init_rows=None,
) -> IvfIndex:
    """IVF build for large corpora, on the embeddings' device: k-means on a
    ``train_subsample`` (~40 points per centroid), assignments in chunks so
    the (N, nlist) similarity never materializes, the bucket fill as one
    gather.  The subsample and ``init_rows`` (the initial centroids, rows
    of the training set) default to seeded draws.  ``dtype="int8"``
    quantizes bucket entries per vector."""
    if dtype not in ("float32", "int8"):
        raise ValueError(f"IVF bucket dtype {dtype!r}")
    emb = torch.as_tensor(embeddings)
    n, d = emb.shape
    nlist = min(nlist, max(n, 1))
    sub = min(n, train_subsample or max(nlist * 40, 4096))
    if assign_chunk is None:
        # keep the per-chunk (chunk, nlist) f32 similarity around 128 MB
        assign_chunk = max(1024, min(65536, (1 << 27) // max(nlist * 4, 1)))
    if sub < n:
        train = emb[_choose_rows(n, sub, seed).to(emb.device)]
    else:
        train = emb
    if init_rows is None:
        init_rows = _choose_rows(train.shape[0], nlist, seed)
    cent, _ = _kmeans(train, nlist, iters, _as_rows(init_rows),
                      min(assign_chunk, sub))
    assign = _assign_chunked(emb, cent, assign_chunk).cpu().numpy()
    return _ivf_from_assignment(emb, cent, assign, nlist, dtype)


def build_ivf_index(
    embeddings, nlist: int = 64, iters: int = 10, seed: int = 0,
    dtype: str = "float32", init_rows=None, device: DeviceLike = None,
) -> IvfIndex:
    """IVF over (n, D) embeddings (numpy or a tensor), k-means over all rows.
    ``init_rows`` are the initial centroids' rows (a seeded draw by
    default).  ``dtype="int8"`` scalar-quantizes the bucket entries per
    vector; centroids and the coarse quantizer stay f32."""
    if dtype not in ("float32", "int8"):
        raise ValueError(f"IVF bucket dtype {dtype!r}")
    dev = resolve_device(device)
    emb = torch.as_tensor(embeddings).to(dev, torch.float32)
    n = emb.shape[0]
    nlist = min(nlist, max(n, 1))
    if init_rows is None:
        init_rows = _choose_rows(n, nlist, seed)
    cent, assign = _kmeans(emb, nlist, iters, _as_rows(init_rows), max(n, 1))
    return _ivf_from_assignment(emb, cent, assign.cpu().numpy(), nlist, dtype)


def ivf_index_from_arrays(arrays: Dict[str, np.ndarray], meta: dict,
                          device: DeviceLike = None) -> IvfIndex:
    """An ``IvfIndex`` from numpy arrays by field name (``centroids``,
    ``buckets``, ``bucket_rows``, ``bucket_counts``, optional
    ``bucket_scale``) and ``meta`` with ``n_docs``, ``nlist`` and
    ``bucket_pad``.  Carries an index built by the JAX package across."""
    dev = resolve_device(device)
    t = {k: torch.from_numpy(np.array(v)).to(dev) for k, v in arrays.items()}
    return IvfIndex(**t, n_docs=int(meta["n_docs"]), nlist=int(meta["nlist"]),
                    bucket_pad=int(meta["bucket_pad"]))


def ivf_search(index: IvfIndex, q: torch.Tensor, top_k: int = 10,
               nprobe: int = 8):
    """Probe the nprobe nearest clusters per query; exact search inside.
    Queries run in chunks that keep the f32 bucket gather under 256 MB; a
    chunk's answers do not depend on the others."""
    nprobe = min(nprobe, index.nlist)
    Q, D = q.shape
    per_query = nprobe * index.bucket_pad * D * 4
    chunk = max(1, _IVF_GATHER_BYTES // max(per_query, 1))
    outs = [_ivf_search_chunk(index, q[s:s + chunk], top_k, nprobe)
            for s in range(0, Q, chunk)]
    if not outs:
        empty = torch.zeros((0, top_k), device=q.device)
        return empty, empty.long()
    return (torch.cat([v for v, _ in outs]), torch.cat([r for _, r in outs]))


@ieee_f32()
def _ivf_search_chunk(index: IvfIndex, q: torch.Tensor, top_k: int,
                      nprobe: int):
    Q = q.shape[0]
    c_sim = q @ index.centroids.T                            # (Q, nlist)
    _, probe = fast_topk(c_sim, nprobe)                      # (Q, nprobe)
    cand_emb = index.buckets[probe].float()                  # (Q, np, Bp, D)
    cand_rows = index.bucket_rows[probe]                     # (Q, np, Bp)
    cand_cnt = index.bucket_counts[probe]                    # (Q, np)
    scores = torch.einsum("qd,qpbd->qpb", q.float(), cand_emb)
    if index.buckets.dtype == torch.int8:
        scores = scores * index.bucket_scale[probe]
    slot = torch.arange(scores.shape[2], device=q.device)
    scores = torch.where(slot < cand_cnt[..., None], scores,
                         torch.full((), NEG_INF, device=q.device))
    flat_scores = scores.reshape(Q, -1)
    flat_rows = cand_rows.reshape(Q, -1).long()
    k = min(top_k, flat_scores.shape[1])
    vals, sel = fast_topk(flat_scores, k)
    return _pad_topk(vals, flat_rows.gather(1, sel), top_k)


# --------------------------------------------------------------------------
# Encoding
# --------------------------------------------------------------------------

def _encode_texts(model: torch.nn.Module, cfg: DenseConfig,
                  texts: Sequence[str], batch: int = 256) -> torch.Tensor:
    """Batched encoder forward over a text list → (n, dim) f32 embeddings on
    the model's device.  Batches are padded with empty texts to
    ``_pad_target``; nothing is copied to the host (``tdr`` pulls groups of
    batches to the host instead)."""
    dev = module_device(model)
    if not texts:
        return torch.zeros((0, cfg.dim), dtype=torch.float32, device=dev)
    outs = []
    for s in range(0, len(texts), batch):
        chunk = list(texts[s:s + batch])
        n = len(chunk)
        target = _pad_target(n, batch)
        chunk += [""] * (target - n)
        ids, mask = encode_batch(chunk, cfg.vocab_size, cfg.max_len)
        outs.append(encode(model, ids, mask)[:n])
    return torch.cat(outs, dim=0)


# --------------------------------------------------------------------------
# Dense retrieval model (encoder + index + docids)
# --------------------------------------------------------------------------

@dataclass
class DenseModel:
    """Encoder + corpus embedding index, mirroring the reference's
    embed-then-FAISS pipeline as one object.  The encoder is the trainable
    ``DualEncoder``, the HF-architecture ``BertEncoder``
    (``models.convert``) or the MLA + MoE ``MlaMoeEncoder``
    (``models.mla_moe``); it holds its own weights (``tdr`` passes a flax
    param tree beside the module).  ``cfg`` gives the tokenizer's vocab and
    ``max_len`` and the embedding width (a ``DenseConfig``, or the
    ``MlaMoeConfig`` itself)."""

    model: torch.nn.Module
    cfg: DenseConfig
    docids: List[str]
    flat: Optional[FlatIndex] = None
    ivf: Optional[IvfIndex] = None

    @classmethod
    def build(cls, model: torch.nn.Module, cfg: DenseConfig,
              texts: Sequence[str], docids: Sequence[str], batch: int = 256,
              with_ivf: bool = False) -> "DenseModel":
        dev = module_device(model)
        emb = _encode_texts(model, cfg, texts, batch)
        out = cls(model=model, cfg=cfg, docids=list(docids),
                  flat=build_flat_index(emb, device=dev))
        if with_ivf:
            out.ivf = build_ivf_index(emb, nlist=cfg.ivf_nlist, device=dev)
        return out

    def encode_queries(self, texts: Sequence[str],
                       batch: int = 256) -> torch.Tensor:
        return _encode_texts(self.model, self.cfg, texts, batch)

    def retrieve(self, queries: Sequence[str], k: int = 10,
                 use_ivf: bool = False,
                 nprobe: Optional[int] = None) -> List[List[str]]:
        q = self.encode_queries(queries)
        if use_ivf:
            if self.ivf is None:
                raise ValueError("build with with_ivf=True first")
            vals, rows = ivf_search(self.ivf, q, top_k=k,
                                    nprobe=nprobe or self.cfg.ivf_nprobe)
        else:
            vals, rows = flat_search(self.flat, q, top_k=k)
        vals, rows = vals.cpu().numpy(), rows.cpu().numpy()
        return [
            [self.docids[r] for r, v in zip(qr, qv) if np.isfinite(v)]
            for qr, qv in zip(rows, vals)
        ]


def evaluate_dense(
    dense: DenseModel,
    queries: Sequence[str],
    positives: Sequence[str],
    langs: Optional[Sequence[str]] = None,
    k: int = 10,
    nprobes: Sequence[int] = (1, 2, 4, 8, 16),
) -> dict:
    """Held-out evaluation report for a dense retriever: flat (exact)
    recall@k, the IVF recall-vs-nprobe curve, and a per-language breakdown
    when ``langs`` is given."""
    from tdr_torch.eval.metrics import recall_at_k

    report: dict = {"n_queries": len(queries), "k": k}
    flat_res = dense.retrieve(queries, k=k)
    report["flat_recall"] = recall_at_k(flat_res, positives, k)
    if langs is not None:
        by_lang: dict = {}
        for i, l in enumerate(langs):
            by_lang.setdefault(l, []).append(i)
        report["flat_recall_per_lang"] = {
            l: recall_at_k([flat_res[i] for i in idx],
                           [positives[i] for i in idx], k)
            for l, idx in sorted(by_lang.items())
        }
    if dense.ivf is not None:
        nlist = int(dense.ivf.centroids.shape[0])
        report["ivf_recall_vs_nprobe"] = {
            int(p): recall_at_k(
                dense.retrieve(queries, k=k, use_ivf=True, nprobe=int(p)),
                positives, k)
            for p in nprobes if p <= nlist
        }
    return report
