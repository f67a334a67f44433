"""Document-sharded indexing and scoring with a top-k merge (from
``tdr/parallel/sharded.py``).

The document axis is split into contiguous ranges, one per shard; each
shard is a ``SparseIndex`` of its local doc rows on its mesh device, built
against corpus-global statistics (idf, avgdl, head selection, the tail
width), so it scores its documents as the single-device index does.  Each
shard scores the queries with the single-device fused engine
(``head_engine="matmul"``; a tail-bearing shard runs the ``tail_compact``
kernel once a batch) and keeps a local top-k; the merge gathers the S·k
candidates and takes the global top-k.

``grid_score_topk`` composes this with query data parallelism (queries
over "data", documents over "model"); ``dp_score_topk`` replicates one
index and splits the query batch.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tdr_torch.index.build import (SparseIndex, _auto_head_size, _bucket,
                                   _round_up, _tail_pmax, build_index,
                                   compute_idf, segment_df, select_head)
from tdr_torch.ops.score import (_fused_topk_core, _scatter_topk,
                                 score_and_topk)
from tdr_torch.ops.topk import merge_gathered_topk
from tdr_torch.parallel.mesh import (Mesh, _copy, all_gather, data_sharding,
                                     psum, replicated)
from tdr_torch.utils.config import BM25Config, IndexConfig
from tdr_torch.utils.device import DeviceLike, resolve_device

# stacked per-shard fields in ``tdr``'s layout, and where each lives in a
# shard's SparseIndex
_STACKED = {"indptr": lambda s: s.indptr,
            "postings_doc": lambda s: s.postings_doc,
            "postings_w": lambda s: s.postings_w,
            "postings_tf": lambda s: s.postings_tf,
            "head_rows": lambda s: s.head_rows,
            "df_local": lambda s: s.stats.df,
            "doc_len": lambda s: s.stats.doc_len,
            "head_scale": lambda s: s.head_scale}


@dataclass
class ShardedSparseIndex:
    """One ``SparseIndex`` of local doc rows per shard (shard s on its mesh
    device), with the corpus-global ``head_slot``, ``idf`` and ``avgdl``
    shared by all of them.  ``stacked(name)`` views a per-shard field as
    ``tdr`` lays it out, (S, ...)."""

    shards: List[SparseIndex]
    n_valid: torch.Tensor        # (S,) int32 on the host: docs per shard
    n_shards: int = 1
    n_docs: int = 0
    n_docs_pad_local: int = 0
    vocab_size: int = 0
    tail_pmax: int = 0
    head_size: int = 0
    _placed: Dict[Tuple[int, str], SparseIndex] = field(
        default_factory=dict, repr=False)

    @property
    def head_slot(self) -> torch.Tensor:
        return self.shards[0].head_slot

    @property
    def idf(self) -> torch.Tensor:
        return self.shards[0].stats.idf

    @property
    def avgdl(self) -> torch.Tensor:
        return self.shards[0].stats.avgdl

    def shard_field(self, name: str, s: int) -> torch.Tensor:
        """Shard ``s``'s entry of the stacked field ``name``."""
        return _STACKED[name](self.shards[s])

    def stacked(self, name: str, device: DeviceLike = "cpu") -> torch.Tensor:
        return torch.stack([self.shard_field(name, s).to(device)
                            for s in range(self.n_shards)])

    def on(self, s: int, device: torch.device) -> SparseIndex:
        """Shard ``s`` on ``device``; a copy is made once and kept (the grid
        layout replicates each shard over the "data" axis)."""
        sh = self.shards[s]
        if sh.device == device:
            return sh
        key = (s, str(device))
        if key not in self._placed:
            self._placed[key] = sh.to(device)
        return self._placed[key]


def _shard_bounds(n_docs: int, n_shards: int) -> np.ndarray:
    return np.linspace(0, n_docs, n_shards + 1).astype(np.int64)


def _rows_to_docs(rows, n_docs: int, n_shards: int, pad: int):
    """Global rows (shard·pad + local) to corpus rows: numpy in, numpy out,
    or a tensor on its own device."""
    bounds = _shard_bounds(n_docs, n_shards)
    if isinstance(rows, torch.Tensor):
        b = torch.as_tensor(bounds, device=rows.device)
        return b[torch.div(rows, pad, rounding_mode="floor").long()] + rows % pad
    return bounds[rows // pad] + rows % pad


def _shard_devices(devices: Optional[Sequence[DeviceLike]], n_shards: int):
    if devices is None:
        return [None] * n_shards          # resolve_device's default, per shard
    devices = list(devices)
    return [devices[s % len(devices)] for s in range(n_shards)]


def spmd_global_stats(mesh: Mesh, term_ids, doc_len, vocab_size: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Corpus-global (df, total doc length): per-shard counts on each data
    device, then a ``psum`` to the mesh's first device.  ``term_ids`` (S,
    nnz_pad) and ``doc_len`` (S, N_loc_pad), stacked or as lists of
    per-shard tensors; term-id padding equals ``vocab_size``."""
    devs = mesh.axis_devices("data")
    dfs, totals = [], []
    for s, dev in enumerate(devs):
        dfs.append(segment_df(_copy(torch.as_tensor(term_ids[s]), dev),
                              vocab_size))
        totals.append(_copy(torch.as_tensor(doc_len[s]), dev).sum())
    return psum(dfs, mesh.first), psum(totals, mesh.first)


def build_sharded_index(
    doc_ids: np.ndarray,
    term_ids: np.ndarray,
    tfs: np.ndarray,
    doc_lens: np.ndarray,
    vocab_size: int,
    n_shards: int,
    bm25: BM25Config = BM25Config(),
    index_cfg: IndexConfig = IndexConfig(),
    weight_kind: str = "bm25",
    head_size: Optional[int] = None,
    devices: Optional[Sequence[DeviceLike]] = None,
) -> ShardedSparseIndex:
    """Partition documents into ``n_shards`` contiguous ranges and build
    each shard against corpus-global statistics, shard s on
    ``devices[s]`` (``Mesh.axis_devices``; default the ``resolve_device``
    rule).  ``head_size`` defaults to ``tdr``'s choice from the local
    padded length; pass the single-device index's to keep its head/tail
    split (and so its head dtype per term)."""
    n_docs = int(doc_lens.shape[0])
    bounds = _shard_bounds(n_docs, n_shards)
    n_local = np.diff(bounds)
    n_loc_pad = max(
        _round_up(max(int(n_local.max()) if n_docs else 1, 1),
                  index_cfg.doc_pad_multiple),
        index_cfg.doc_pad_multiple)
    if index_cfg.shape_bucketing:
        n_loc_pad = _bucket(n_loc_pad, index_cfg.doc_pad_multiple)
        vocab_size = _bucket(max(vocab_size, 1), 128)

    # ---- corpus-global statistics, on the first shard's device -------------
    shard_devs = _shard_devices(devices, n_shards)
    term_ids = np.asarray(term_ids)
    df_g = segment_df(torch.as_tensor(term_ids,
                                      device=resolve_device(shard_devs[0])),
                      vocab_size)
    idf_variant = bm25.idf_variant if weight_kind == "bm25" else "classic"
    idf = compute_idf(df_g, n_docs, idf_variant)
    if head_size is None:
        if index_cfg.head_min_df > 0:
            head_size = int((df_g >= index_cfg.head_min_df).sum())
        else:
            head_size = _auto_head_size(vocab_size, n_loc_pad, index_cfg)
    head_size = min(head_size, vocab_size)
    head_slot = select_head(df_g, head_size)
    avgdl = float(doc_lens.sum() / max(n_docs, 1))
    # one tail width for every shard: the widest GLOBAL tail list
    tail_pmax = _tail_pmax(df_g, head_slot, index_cfg.shape_bucketing)

    # ---- per-shard builds --------------------------------------------------
    doc_ids = np.asarray(doc_ids)
    per_entry_shard = np.searchsorted(bounds[1:], doc_ids, side="right")
    nnz = int(doc_ids.shape[0])
    max_local_nnz = (int(np.bincount(per_entry_shard,
                                     minlength=n_shards).max()) if nnz else 1)
    nnz_pad = max(_round_up(max(max_local_nnz, 1), index_cfg.nnz_pad_multiple),
                  index_cfg.nnz_pad_multiple)
    if index_cfg.shape_bucketing:
        nnz_pad = _bucket(nnz_pad, index_cfg.nnz_pad_multiple)

    shards = []
    for s, dev in enumerate(shard_devs):
        sel = per_entry_shard == s
        shards.append(build_index(
            doc_ids[sel] - bounds[s], term_ids[sel], np.asarray(tfs)[sel],
            doc_lens[bounds[s]:bounds[s + 1]], vocab_size, bm25=bm25,
            index_cfg=index_cfg, weight_kind=weight_kind, head_size=head_size,
            idf=idf, head_slot=head_slot, avgdl=avgdl, n_docs_pad=n_loc_pad,
            nnz_pad=nnz_pad, tail_pmax=tail_pmax, device=dev))
    return ShardedSparseIndex(
        shards=shards, n_valid=torch.as_tensor(n_local, dtype=torch.int32),
        n_shards=n_shards, n_docs=n_docs, n_docs_pad_local=n_loc_pad,
        vocab_size=vocab_size, tail_pmax=tail_pmax, head_size=head_size)


def _local_topk(pairs, top_k: int, tail_budget: int = 2048):
    """Each (index, qids, qw, n_valid) scored by the single-device fused
    engine at ``top_k`` (at ``score_and_topk_fused``'s default budget, as in
    ``tdr``): every shard's work is dispatched first, then each overflow
    flag is read (one bool a shard, as ``score_and_topk_fused`` reads it)
    and its queries re-scored by the scatter path."""
    cores = [_fused_topk_core(ix, q, w, top_k, tail_budget, n_valid=nv)
             for ix, q, w, nv in pairs]
    out = []
    for (ix, q, w, nv), (vals, docs, overflow) in zip(pairs, cores):
        if bool(overflow.any()):
            sv, sd = _scatter_topk(ix, q, w, top_k, nv)
            vals = torch.where(overflow[:, None], sv, vals)
            docs = torch.where(overflow[:, None], sd, docs)
        out.append((vals, docs))
    return out


def _to_global(vals: torch.Tensor, rows: torch.Tensor, s: int,
               n_loc_pad: int) -> torch.Tensor:
    # a -inf entry can carry the tail sentinel (one past the local range):
    # pin it to local row 0 BEFORE the offset, or it points into shard s+1
    rows = torch.where(torch.isfinite(vals), rows, torch.zeros_like(rows))
    return rows + s * n_loc_pad


def sharded_score_topk(mesh: Mesh, sindex: ShardedSparseIndex,
                       qids: torch.Tensor, qw: torch.Tensor, top_k: int = 10
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score replicated queries against the doc-sharded index: shard s on
    data device s, local top-k, then a gather of every shard's candidates
    to the mesh's first device and a global top-k.  Returns (vals (Q, k),
    GLOBAL rows (Q, k)) there; ``global_row_to_doc`` maps rows to docs."""
    devs = mesh.axis_devices("data")
    if len(devs) != sindex.n_shards:
        raise ValueError(f"{sindex.n_shards} shards on a data axis of "
                         f"{len(devs)}")
    k_local = min(top_k, sindex.n_docs_pad_local)
    pairs = [(sindex.on(s, d), _copy(qids, d), _copy(qw, d),
              int(sindex.n_valid[s])) for s, d in enumerate(devs)]
    local = _local_topk(pairs, k_local)
    vals_g = all_gather([v for v, _ in local], mesh.first)
    rows_g = all_gather([_to_global(v, r, s, sindex.n_docs_pad_local)
                         for s, (v, r) in enumerate(local)], mesh.first)
    return merge_gathered_topk(vals_g, rows_g, top_k)


def _pad_queries(qids: torch.Tensor, qw: torch.Tensor, n: int):
    Q = qids.shape[0]
    Q_pad = -(-Q // n) * n
    if Q_pad != Q:
        qids = torch.nn.functional.pad(qids, (0, 0, 0, Q_pad - Q))
        qw = torch.nn.functional.pad(qw, (0, 0, 0, Q_pad - Q))
    return qids, qw


def grid_score_topk(mesh: Mesh, sindex: ShardedSparseIndex,
                    qids: torch.Tensor, qw: torch.Tensor, top_k: int = 10
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """2-D grid: the query batch split over "data", documents over
    "model".  Device (i, j) scores query block i against shard j (copied
    there once, see ``ShardedSparseIndex.on``); each row of the mesh merges
    its blocks' candidates over "model".  Build the index with ``n_shards =
    mesh.shape["model"]``.  Returns (vals (Q, k), GLOBAL rows (Q, k)) on
    the mesh's first device."""
    S = sindex.n_shards
    if S != mesh.shape["model"]:
        raise ValueError(f"{S} shards on a model axis of {mesh.shape['model']}")
    n_data = mesh.shape["data"]
    Q = qids.shape[0]
    qids, qw = _pad_queries(qids, qw, n_data)
    q_blocks = data_sharding(mesh, qids)
    w_blocks = data_sharding(mesh, qw)
    k_local = min(top_k, sindex.n_docs_pad_local)
    pairs = []
    for i in range(n_data):
        for j, dev in enumerate(mesh.axis_devices("model", i)):
            pairs.append((sindex.on(j, dev), _copy(q_blocks[i], dev),
                          _copy(w_blocks[i], dev), int(sindex.n_valid[j])))
    local = _local_topk(pairs, k_local)
    vals, rows = [], []
    for i in range(n_data):
        row = local[i * S:(i + 1) * S]
        dest = mesh.devices[i, 0]
        v, r = merge_gathered_topk(
            all_gather([v for v, _ in row], dest),
            all_gather([_to_global(v, r, j, sindex.n_docs_pad_local)
                        for j, (v, r) in enumerate(row)], dest), top_k)
        vals.append(v)
        rows.append(r)
    return (torch.cat([_copy(v, mesh.first) for v in vals])[:Q],
            torch.cat([_copy(r, mesh.first) for r in rows])[:Q])


def global_row_to_doc(sindex: ShardedSparseIndex, rows):
    """Map sharded global rows (shard·pad + local) to corpus doc rows;
    numpy in, numpy out, or a tensor on its own device."""
    return _rows_to_docs(rows, sindex.n_docs, sindex.n_shards,
                         sindex.n_docs_pad_local)


def dp_score_topk(mesh: Mesh, index: SparseIndex, qids: torch.Tensor,
                  qw: torch.Tensor, top_k: int = 10
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Query data parallelism: the index replicated on every data device,
    the query batch split over them, each block through ``score_and_topk``
    (``tdr``'s engine here), the results concatenated on the mesh's first
    device.  A replica on another card is copied at each call, as
    ``tdr``'s ``device_put`` does; on the index's own device it is the
    index."""
    n_data = mesh.shape["data"]
    Q = qids.shape[0]
    qids, qw = _pad_queries(qids, qw, n_data)
    out = [score_and_topk(ix, q, w, top_k=top_k) for ix, q, w in zip(
        replicated(mesh, index), data_sharding(mesh, qids),
        data_sharding(mesh, qw))]
    return (torch.cat([_copy(v, mesh.first) for v, _ in out])[:Q],
            torch.cat([_copy(r, mesh.first) for _, r in out])[:Q])


@dataclass
class ShardedBM25Model:
    """Router-compatible model over a document-sharded index: the
    ``topk_tokens`` / ``topk_tokens_async`` / ``retrieve_tokens`` surface of
    ``SparseModel``, so that a ``LanguageRouter`` mixes single-device and
    sharded languages.  ``layout="doc"`` shards documents over "data"
    (``sharded_score_topk``); ``layout="grid"`` splits queries over "data"
    and documents over "model" (``grid_score_topk``)."""

    vocab: object                 # tdr_torch.text.vocab.Vocab
    sindex: ShardedSparseIndex
    docids: list
    mesh: Mesh
    lang: str = "en"
    max_query_terms: int = 64
    query_weight: str = "unit"
    layout: str = "doc"

    @classmethod
    def from_coo(cls, vocab, coo, docids, mesh: Mesh, lang: str = "en",
                 bm25: Optional[BM25Config] = None,
                 index_cfg: Optional[IndexConfig] = None,
                 max_query_terms: int = 64, layout: str = "doc",
                 head_size: Optional[int] = None) -> "ShardedBM25Model":
        if layout not in ("doc", "grid"):
            raise ValueError(f"unknown layout {layout!r}")
        axis = "data" if layout == "doc" else "model"
        devs = mesh.axis_devices(axis)
        sindex = build_sharded_index(
            *coo, vocab.size, n_shards=len(devs), bm25=bm25 or BM25Config(),
            index_cfg=index_cfg or IndexConfig(), head_size=head_size,
            devices=devs)
        return cls(vocab=vocab, sindex=sindex, docids=list(docids), mesh=mesh,
                   lang=lang, max_query_terms=max_query_terms, layout=layout)

    @classmethod
    def build(cls, doc_token_lists, docids, mesh: Mesh, lang: str = "en",
              bm25: Optional[BM25Config] = None,
              index_cfg: Optional[IndexConfig] = None,
              max_query_terms: int = 64, layout: str = "doc",
              head_size: Optional[int] = None) -> "ShardedBM25Model":
        from tdr_torch.text.vocab import build_vocab, encode_docs

        index_cfg = index_cfg or IndexConfig()
        vocab = build_vocab(doc_token_lists, min_df=index_cfg.min_df)
        return cls.from_coo(vocab, encode_docs(doc_token_lists, vocab), docids,
                            mesh, lang=lang, bm25=bm25, index_cfg=index_cfg,
                            max_query_terms=max_query_terms, layout=layout,
                            head_size=head_size)

    def encode_query_tokens(self, token_lists):
        from tdr_torch.text.vocab import encode_queries

        qids, qw = encode_queries(token_lists, self.vocab, self.max_query_terms)
        return torch.from_numpy(qids), torch.from_numpy(qw)

    def topk_tokens_async(self, token_lists, k: int = 10, pad_to=None):
        """(vals (Q, k), corpus doc rows (Q, k)) on the mesh's first device,
        and the real query count."""
        n = len(token_lists)
        if pad_to is not None and n < pad_to:
            token_lists = list(token_lists) + [[]] * (pad_to - n)
        qids, qw = self.encode_query_tokens(token_lists)
        qids, qw = _copy(qids, self.mesh.first), _copy(qw, self.mesh.first)
        run = grid_score_topk if self.layout == "grid" else sharded_score_topk
        vals, grows = run(self.mesh, self.sindex, qids, qw, top_k=k)
        return vals, global_row_to_doc(self.sindex, grows), n

    def topk_tokens(self, token_lists, k: int = 10, pad_to=None):
        vals, rows, n = self.topk_tokens_async(token_lists, k, pad_to)
        return vals.cpu().numpy()[:n], rows.cpu().numpy()[:n]

    def retrieve_tokens(self, token_lists, k: int = 10):
        vals, rows = self.topk_tokens(token_lists, k, pad_to=len(token_lists))
        return [[self.docids[r] for r, v in zip(qr, qv) if np.isfinite(v)]
                for qr, qv in zip(rows, vals)]
