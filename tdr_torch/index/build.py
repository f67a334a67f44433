"""Index build for the port: term-doc statistics + the sparse score-row index.

Counterpart of ``tdr/index/build.py``.  The layout is the same — a dense
``(D, N_pad)`` head of premultiplied score rows for the top-df terms plus a
flat CSR over all terms — and the static-shape rules (``_bucket``,
``_pad_docs``, ``full_head_bytes``, ``_auto_head_size``, the 256-floor of
``head_size``, the ``tail_pmax`` bucketing and the postings padding past
nnz) are copied exactly, so every padded shape equals the JAX build's.

Global statistics (df, idf, head selection, ``tail_pmax``) are computed on
the host with numpy, as the JAX build's ``df_host`` path does; the per-entry
work (score weights, the CSR sort and the head scatter) runs as torch ops on
the index's device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from tdr_torch.utils.config import BM25Config, IndexConfig
from tdr_torch.utils.device import DeviceLike, resolve_device


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _bucket(n: int, multiple: int = 128) -> int:
    """Round n up onto a {2^k, 1.5·2^k} geometric grid (then to a hardware
    multiple), as ``tdr.index.build._bucket``."""
    n = max(n, 1)
    k = max((n - 1).bit_length() - 1, 0)
    for cand in (1 << k, (3 << k) // 2, 1 << (k + 1), 3 << k):
        if cand >= n:
            return _round_up(cand, multiple)
    return _round_up(n, multiple)


def _compute_idf_np(df: np.ndarray, n_docs: int, variant: str) -> np.ndarray:
    """The idf formula in numpy float32, as ``tdr``'s host build runs it."""
    n = np.float32(n_docs)
    if variant in ("bm25", "bm25_plus1"):
        return np.log1p((n - df + 0.5) / (df + 0.5)).astype(np.float32)
    if variant == "classic":
        return (np.log((n + 1.0) / (df + 1.0)) + 1.0).astype(np.float32)
    raise ValueError(f"unknown idf variant: {variant}")


def compute_idf(df, n_docs: int, variant: str = "bm25",
                device: DeviceLike = None) -> torch.Tensor:
    """df (V,) → idf (V,) float32, on ``df``'s device (a tensor) or on
    ``resolve_device(device)`` (an array).

    variant="bm25" and "bm25_plus1": ln(1 + (N-df+0.5)/(df+0.5));
    variant="classic": ln((N+1)/(df+1)) + 1.

    On the CPU the formula runs in numpy, as ``tdr``'s host build
    (``df_host``) runs it, so a CPU build's idf equals ``tdr``'s bit for
    bit; on the card it runs as torch ops in float32, whose ``log1p`` may
    round an ulp away from numpy's.  ``build_index`` calls it on its own
    device, so the index's idf is this function's result there."""
    if not isinstance(df, torch.Tensor):
        df = torch.as_tensor(np.asarray(df, np.float32),
                             device=resolve_device(device))
    df = df.to(torch.float32)
    if df.device.type == "cpu":
        return torch.from_numpy(_compute_idf_np(df.numpy(), n_docs, variant))
    n = torch.tensor(n_docs, dtype=torch.float32, device=df.device)
    if variant in ("bm25", "bm25_plus1"):
        return torch.log1p((n - df + 0.5) / (df + 0.5))
    if variant == "classic":
        return torch.log((n + 1.0) / (df + 1.0)) + 1.0
    raise ValueError(f"unknown idf variant: {variant}")


def segment_df(term_ids, vocab_size: int) -> torch.Tensor:
    """Document frequency per term, float32 (V,), from COO term ids (one
    entry per unique (doc, term) pair), on their device; ids at or past
    ``vocab_size`` (the padding) are not counted."""
    ti = torch.as_tensor(term_ids).long()
    valid = ti < vocab_size
    df = torch.zeros(vocab_size, dtype=torch.float32, device=ti.device)
    return df.index_add_(0, torch.where(valid, ti, 0), valid.float())


def select_head(df: torch.Tensor, head_size: int) -> torch.Tensor:
    """head_slot (V,) int32: slot in [0, head_size) for the top-df terms in
    ``lax.top_k``'s order (df descending, lowest term id first among equal
    df), -1 for the others and for terms of zero df."""
    vocab_size = df.shape[0]
    head_slot = torch.full((vocab_size,), -1, dtype=torch.int32,
                           device=df.device)
    if head_size > 0:
        # a stable sort keeps equal df in term order (torch.topk may not)
        order = torch.sort(df, descending=True, stable=True).indices[:head_size]
        keep = df[order] > 0
        head_slot[order[keep]] = torch.arange(
            order.numel(), dtype=torch.int32, device=df.device)[keep]
    return head_slot


def _quantize_head_rows(head_rows: torch.Tensor):
    """Per-doc-column symmetric int8 quantization of the dense head:
    ``head[d, n] ≈ q8[d, n] * scale[n]`` (see tdr.index.build)."""
    rows = head_rows.float()
    colmax = rows.abs().amax(dim=0)
    scale = colmax / 127.0
    inv = torch.where(scale > 0, 1.0 / scale.clamp_min(1e-30),
                      torch.zeros_like(scale))
    q8 = torch.round(rows * inv[None, :]).to(torch.int8)
    return q8, scale


def quantize_head(index: "SparseIndex") -> "SparseIndex":
    """Copy of ``index`` with an int8 scalar-quantized head; no-op if it is
    quantized already."""
    if index.head_rows.dtype == torch.int8:
        return index
    q8, scale = _quantize_head_rows(index.head_rows)
    return dataclasses.replace(index, head_rows=q8, head_scale=scale)


@dataclass
class IndexStats:
    """Per-partition statistics; ``df`` is the local postings length."""

    df: torch.Tensor          # (V,) float32
    idf: torch.Tensor         # (V,) float32
    doc_len: torch.Tensor     # (N_pad,) float32, zero beyond n_docs
    avgdl: torch.Tensor       # () float32

    def to(self, device: DeviceLike) -> "IndexStats":
        return IndexStats(*(t.to(device) for t in
                            (self.df, self.idf, self.doc_len, self.avgdl)))


@dataclass
class SparseIndex:
    """Sparse score-row index: dense head + flat-CSR tail, as tensors on one
    device (``tdr.index.build.SparseIndex`` field for field)."""

    indptr: torch.Tensor          # (V+1,) int32
    postings_doc: torch.Tensor    # (nnz_pad,) int32, padded with 0
    postings_w: torch.Tensor      # (nnz_pad,) float32, padded 0
    postings_tf: torch.Tensor     # (nnz_pad,) float32, padded 0
    head_slot: torch.Tensor       # (V,) int32: slot in head_rows, or -1
    head_rows: torch.Tensor       # (D, N_pad) float32 / bfloat16 / int8
    stats: IndexStats
    head_scale: Optional[torch.Tensor] = None   # (N_pad,) float32, int8 heads

    n_docs: int = 0
    n_docs_pad: int = 0
    vocab_size: int = 0
    tail_pmax: int = 0
    head_size: int = 0

    @property
    def device(self) -> torch.device:
        return self.head_rows.device

    @property
    def nnz(self) -> int:
        """Padded postings length."""
        return int(self.postings_doc.shape[0])

    def memory_bytes(self) -> int:
        """Bytes of every tensor of the index, ``stats`` and ``head_scale``
        included (``tdr``'s sum over the pytree's leaves)."""
        tensors = [getattr(self, f) for f in _INDEX_ARRAYS + ("head_scale",)]
        tensors += [getattr(self.stats, f) for f in _STATS_ARRAYS]
        return sum(t.numel() * t.element_size() for t in tensors
                   if t is not None)

    def to(self, device: DeviceLike) -> "SparseIndex":
        dev = torch.device(device)
        return dataclasses.replace(
            self,
            indptr=self.indptr.to(dev), postings_doc=self.postings_doc.to(dev),
            postings_w=self.postings_w.to(dev),
            postings_tf=self.postings_tf.to(dev),
            head_slot=self.head_slot.to(dev), head_rows=self.head_rows.to(dev),
            stats=self.stats.to(dev),
            head_scale=(None if self.head_scale is None
                        else self.head_scale.to(dev)))


def _build_core(
    doc_ids: torch.Tensor,      # (nnz_pad,) int32, padding has term_id == vocab_size
    term_ids: torch.Tensor,     # (nnz_pad,) int32
    tfs: torch.Tensor,          # (nnz_pad,) float32, padded 0
    doc_len: torch.Tensor,      # (n_docs_pad,) float32
    idf: torch.Tensor,          # (V,) float32
    head_slot: torch.Tensor,    # (V,) int32
    avgdl: torch.Tensor,        # () float32
    *,
    vocab_size: int,
    n_docs_pad: int,
    head_size: int,
    k1: float,
    b: float,
    dl_scaled_by_b: bool,
    weight_kind: str,           # "bm25" | "tfidf"
):
    valid = term_ids < vocab_size
    t_clamped = torch.where(valid, term_ids, 0).long()
    d_clamped = doc_ids.clamp(0, n_docs_pad - 1).long()
    dev = term_ids.device

    df_local = segment_df(term_ids, vocab_size)   # CSR segment bounds

    # per-entry score weight (same operation order as the JAX build)
    dl = doc_len[d_clamped]
    if weight_kind == "bm25":
        norm = (b if dl_scaled_by_b else 1.0) * dl / avgdl
        denom = tfs + k1 * (1.0 - b + norm)
        w = idf[t_clamped] * tfs * (k1 + 1.0) / torch.where(
            denom > 0, denom, torch.ones_like(denom))
    elif weight_kind == "tfidf":
        w = idf[t_clamped] * tfs
    else:
        raise ValueError(weight_kind)
    w = torch.where(valid, w, torch.zeros_like(w))

    if weight_kind == "tfidf":
        sq = torch.zeros(n_docs_pad, dtype=torch.float32, device=dev)
        sq.index_add_(0, d_clamped, w * w)
        # rsqrt in f64, rounded once to f32: the f32 rsqrt rounds twice on
        # the CPU (1/sqrt) and is approximate on the card.  The reference
        # (XLA:CPU) approximates too, from the CPU's own rsqrt instruction,
        # which no port can replay; the correctly rounded norm is the
        # nearest f32 to both.
        inv = torch.where(sq > 0, torch.rsqrt(sq.double()).float(),
                          torch.zeros_like(sq))
        w = w * inv[d_clamped]

    # CSR layout: stable sort by term id (padding term_id == V sorts last)
    order = torch.argsort(term_ids, stable=True)
    valid_o = valid[order]
    postings_doc = torch.where(valid_o, doc_ids[order], 0).to(torch.int32)
    postings_w = w[order]
    postings_tf = torch.where(valid_o, tfs[order], torch.zeros_like(tfs))
    indptr = torch.cat([
        torch.zeros(1, dtype=torch.int32, device=dev),
        torch.cumsum(df_local.to(torch.int32), 0, dtype=torch.int32)])

    # dense head rows: scatter-add the premultiplied weights
    entry_slot = head_slot.long()[t_clamped]
    in_head = (entry_slot >= 0) & valid
    head_rows = torch.zeros((max(head_size, 1), n_docs_pad),
                            dtype=torch.float32, device=dev)
    head_rows.index_put_(
        (torch.where(in_head, entry_slot, 0), d_clamped),
        torch.where(in_head, w, torch.zeros_like(w)), accumulate=True)
    return indptr, postings_doc, postings_w, postings_tf, head_rows, df_local


def _pad_docs(n_docs: int, cfg: IndexConfig) -> int:
    n_docs_pad = max(_round_up(max(n_docs, 1), cfg.doc_pad_multiple),
                     cfg.doc_pad_multiple)
    if cfg.shape_bucketing:
        n_docs_pad = _bucket(n_docs_pad, cfg.doc_pad_multiple)
    return n_docs_pad


def _head_itemsize(cfg: IndexConfig) -> int:
    return {"bfloat16": 2, "int8": 1}.get(cfg.head_dtype, 4)


def full_head_bytes(vocab_size: int, n_docs: int, cfg: IndexConfig) -> int:
    """Device bytes for a dense head row per vocab term (the router's
    waterfill cap)."""
    n_docs_pad = _pad_docs(n_docs, cfg)
    vocab_pad = _bucket(max(vocab_size, 1), 128) if cfg.shape_bucketing else vocab_size
    return vocab_pad * n_docs_pad * _head_itemsize(cfg)


def _auto_head_size(vocab_size: int, n_docs_pad: int, cfg: IndexConfig) -> int:
    """Head row count from the device byte budget at the head's dtype."""
    if n_docs_pad == 0:
        return 0
    d = int(cfg.head_budget_bytes // (_head_itemsize(cfg) * n_docs_pad))
    d = max(0, min(d, vocab_size))
    return (d // 8) * 8 if d >= 8 else (1 if d > 0 else 0)


def _pad_coo(doc_ids, term_ids, tfs, vocab_size, nnz_pad):
    nnz = int(doc_ids.shape[0])
    di = np.zeros(nnz_pad, np.int32)
    ti = np.full(nnz_pad, vocab_size, np.int32)   # sentinel pads sort last
    tv = np.zeros(nnz_pad, np.float32)
    di[:nnz] = doc_ids
    ti[:nnz] = term_ids
    tv[:nnz] = tfs
    return di, ti, tv


def _bucket_tail_pmax(tail_pmax: int, bucketing: bool) -> int:
    if tail_pmax <= 0:
        return 8
    if bucketing:
        return _bucket(tail_pmax, 8)
    return max(8, _round_up(tail_pmax, 128))


def _as_tensor(x, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    """An array (copied: it may be read-only) or a tensor, on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(dev, dtype)
    return torch.tensor(np.asarray(x), dtype=dtype, device=dev)


def _tail_pmax(df: torch.Tensor, head_slot: torch.Tensor, bucketing: bool
               ) -> int:
    """The static tail width from the widest tail term's df."""
    tail_df = df[head_slot < 0]
    return _bucket_tail_pmax(int(tail_df.max()) if tail_df.numel() else 0,
                             bucketing)


def build_index(
    doc_ids: np.ndarray,
    term_ids: np.ndarray,
    tfs: np.ndarray,
    doc_lens: np.ndarray,
    vocab_size: int,
    bm25: BM25Config = BM25Config(),
    index_cfg: IndexConfig = IndexConfig(),
    weight_kind: str = "bm25",
    head_size: Optional[int] = None,
    idf=None,
    head_slot=None,
    avgdl: Optional[float] = None,
    n_docs_pad: Optional[int] = None,
    nnz_pad: Optional[int] = None,
    tail_pmax: Optional[int] = None,
    df_host: Optional[np.ndarray] = None,
    device: DeviceLike = None,
) -> SparseIndex:
    """Pad the COO to static shapes, run the build on ``device`` and derive
    the static tail width (``tdr.index.build.build_index``'s contract).

    The overrides replace local statistics and shapes with corpus-global
    ones: ``idf`` and ``avgdl`` (the segment store's delta; an injected
    ``idf`` fixes the vocab axis at its length), and for a document shard
    also ``head_slot`` (with ``head_size``), ``tail_pmax`` and the shared
    padded shapes ``n_docs_pad`` and ``nnz_pad``, so that a shard scores
    its documents as the single-device index does.

    The statistics go through the public helpers on ``device``: df from
    ``df_host`` or ``segment_df``, then ``compute_idf`` and
    ``select_head``, so each equals the index's own bit for bit.  ``idf``
    and ``head_slot`` may be arrays or tensors.
    """
    dev = resolve_device(device)
    n_docs = int(doc_lens.shape[0])
    bucketing = index_cfg.shape_bucketing
    if n_docs_pad is None:
        n_docs_pad = _pad_docs(n_docs, index_cfg)
    nnz = int(doc_ids.shape[0])
    nnz_pad_injected = nnz_pad
    if nnz_pad is None:
        nnz_pad = max(_round_up(max(nnz, 1), index_cfg.nnz_pad_multiple),
                      index_cfg.nnz_pad_multiple)
        if bucketing:
            nnz_pad = _bucket(nnz_pad, index_cfg.nnz_pad_multiple)
    vocab_pad = _bucket(max(vocab_size, 1), 128) if bucketing else vocab_size

    di, ti, tv = _pad_coo(doc_ids, term_ids, tfs, vocab_pad, nnz_pad)
    dl = np.zeros(n_docs_pad, np.float32)
    dl[:n_docs] = doc_lens
    if idf is not None:
        vocab_pad = len(idf)
    ti_t = torch.as_tensor(ti, device=dev)

    if idf is None or head_slot is None:
        if df_host is not None:
            df_g = torch.zeros(vocab_pad, dtype=torch.float32, device=dev)
            df_g[:len(df_host)] = _as_tensor(df_host, torch.float32, dev)
        else:
            df_g = segment_df(ti_t[:nnz], vocab_pad)
        if idf is None:
            idf = compute_idf(df_g, n_docs, bm25.idf_variant)
        if head_slot is None:
            if head_size is None:
                if index_cfg.head_min_df > 0:
                    head_size = int((df_g >= index_cfg.head_min_df).sum())
                else:
                    head_size = _auto_head_size(vocab_pad, n_docs_pad, index_cfg)
                if bucketing and 256 < head_size < vocab_pad:
                    head_size = (head_size // 256) * 256   # floor: stay in budget
            head_size = min(head_size, vocab_pad)
            head_slot = select_head(df_g, head_size)
        if tail_pmax is None:
            tail_pmax = _tail_pmax(df_g, head_slot, bucketing)
    idf_t = _as_tensor(idf, torch.float32, dev)
    head_slot_t = _as_tensor(head_slot, torch.int32, dev)
    if head_size is None:
        head_size = int(head_slot_t.max()) + 1 if vocab_pad else 0
    if tail_pmax is None:
        # injected statistics, no tail width: the widest LOCAL tail list
        tail_pmax = _tail_pmax(segment_df(ti_t[:nnz], vocab_pad), head_slot_t,
                               bucketing)
    if avgdl is None:
        avgdl = float(doc_lens.sum() / max(n_docs, 1))

    avgdl_t = torch.tensor(avgdl, dtype=torch.float32, device=dev)
    (indptr, postings_doc, postings_w, postings_tf, head_rows,
     df_local) = _build_core(
        torch.as_tensor(di, device=dev), ti_t,
        torch.as_tensor(tv, device=dev), torch.as_tensor(dl, device=dev),
        idf_t, head_slot_t, avgdl_t,
        vocab_size=vocab_pad, n_docs_pad=n_docs_pad, head_size=head_size,
        k1=bm25.k1, b=bm25.b, dl_scaled_by_b=bm25.dl_scaled_by_b,
        weight_kind=weight_kind,
    )

    head_scale = None
    if index_cfg.head_dtype == "bfloat16":
        head_rows = head_rows.to(torch.bfloat16)
    elif index_cfg.head_dtype == "int8":
        head_rows, head_scale = _quantize_head_rows(head_rows)

    # postings padding past nnz, kept so shapes equal the JAX build's (its
    # TPU tail kernel reads an aligned window past the segment end; the CUDA
    # kernel reads exactly [start, start + len)); an injected ``nnz_pad``
    # grows from itself, so that every shard gets one shape
    dma_win = _round_up(tail_pmax + 1023, 1024)
    need = (nnz_pad_injected if nnz_pad_injected is not None else nnz) + dma_win
    if int(postings_doc.shape[0]) < need:
        grow = (_bucket(need, index_cfg.nnz_pad_multiple) if bucketing
                else _round_up(need, index_cfg.nnz_pad_multiple))
        pad = grow - int(postings_doc.shape[0])
        postings_doc = torch.nn.functional.pad(postings_doc, (0, pad))
        postings_w = torch.nn.functional.pad(postings_w, (0, pad))
        postings_tf = torch.nn.functional.pad(postings_tf, (0, pad))

    stats = IndexStats(df=df_local, idf=idf_t,
                       doc_len=torch.as_tensor(dl, device=dev), avgdl=avgdl_t)
    return SparseIndex(
        indptr=indptr, postings_doc=postings_doc, postings_w=postings_w,
        postings_tf=postings_tf, head_slot=head_slot_t, head_rows=head_rows,
        stats=stats, head_scale=head_scale, n_docs=n_docs,
        n_docs_pad=n_docs_pad, vocab_size=vocab_pad, tail_pmax=tail_pmax,
        head_size=head_size,
    )


def build_tfidf_index(*args, **kwargs) -> SparseIndex:
    """TF-IDF cosine index: same layout, L2-normalized tf·idf rows with the
    classic idf."""
    kwargs.setdefault("weight_kind", "tfidf")
    bm25 = kwargs.pop("bm25", BM25Config(idf_variant="classic"))
    if bm25.idf_variant == "bm25":
        bm25 = dataclasses.replace(bm25, idf_variant="classic")
    return build_index(*args, bm25=bm25, **kwargs)


_INDEX_ARRAYS = ("indptr", "postings_doc", "postings_w", "postings_tf",
                 "head_slot", "head_rows")
_STATS_ARRAYS = ("df", "idf", "doc_len", "avgdl")
_STATIC_FIELDS = ("n_docs", "n_docs_pad", "vocab_size", "tail_pmax", "head_size")


def _tensor_from_saved(arr: np.ndarray, dtype: str, dev: torch.device):
    if dtype == "bfloat16":
        # stored as the uint16 bit pattern
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(arr)).to(dev)


def sparse_index_from_arrays(arrays: Dict[str, np.ndarray], meta: dict,
                             device: DeviceLike = None) -> SparseIndex:
    """A ``SparseIndex`` from numpy arrays in the layout of a ``tdr`` sparse
    checkpoint (``arrays.npz`` + ``meta.json``): index arrays by field name,
    statistics as ``stats_<name>``, ``meta["statics"]`` for the static
    fields and ``meta["dtypes"]`` naming each array's dtype (bf16 arrives as
    its uint16 bits).  Carries an index built by the JAX package across, so
    a scoring fault can be told from a build fault."""
    dev = resolve_device(device)
    dtypes = meta.get("dtypes", {})

    def get(key):
        return _tensor_from_saved(arrays[key], dtypes.get(key, ""), dev)

    kw = {name: get(name) for name in _INDEX_ARRAYS}
    if "head_scale" in arrays:
        kw["head_scale"] = get("head_scale")
    stats = IndexStats(**{name: get(f"stats_{name}") for name in _STATS_ARRAYS})
    statics = {k: int(meta["statics"][k]) for k in _STATIC_FIELDS}
    return SparseIndex(stats=stats, **kw, **statics)
