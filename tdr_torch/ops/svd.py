"""Randomized SVD of the sparse TF-IDF index: the port of ``tdr/ops/svd.py``.

The reference's sklearn TruncatedSVD over scipy CSR
(faiss_based_ANN_Implementation.py:269-278, 256/300 components) as a
randomized range-finder SVD that never forms the dense (N x V) matrix:

    Y = A @ G          (sparse-dense product over the postings, index_add_)
    Q = qr(Y)          (orthonormal range basis)
    B = Q^T @ A        (again over the postings, transposed)
    U_b S V^T = svd(B) (small dense SVD)
    doc embeddings = Q @ U_b * S ;  query projection = V

A is the (N docs x V terms) TF-IDF matrix stored term-major in the
``SparseIndex``.  ``tdr`` draws the (V, rank + oversample) start matrix ``G``
with ``jax.random.normal``, which torch cannot reproduce: the port takes it
as an argument (the JAX draw, to compare the two) and otherwise draws it
from a CPU ``torch.Generator`` seeded with ``seed``, the same on every
device.  Each product builds an (nnz, rank + oversample) f32 intermediate.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tdr_torch.index.build import SparseIndex
from tdr_torch.ops.precision import ieee_f32


def _term_of_posting(index: SparseIndex) -> torch.Tensor:
    """(nnz_pad,) int64: owning term id per posting slot (from indptr)."""
    pos = torch.arange(index.postings_doc.shape[0], device=index.device,
                       dtype=index.indptr.dtype)
    # term t owns [indptr[t], indptr[t+1])
    return torch.searchsorted(index.indptr, pos, right=True) - 1


@ieee_f32()
def tfidf_svd(
    index: SparseIndex, start: Optional[torch.Tensor] = None,
    rank: int = 256, oversample: int = 16, iters: int = 2, seed: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ (doc_emb (N_pad, rank), singular values (rank,), Vt (rank, V)) on
    the index's device.

    ``doc_emb`` rows are the TruncatedSVD doc coordinates (U*S); queries
    project with ``Vt`` (q_low = Vt @ q_sparse).  ``start`` is the (V,
    min(rank + oversample, V, N_pad)) start matrix.
    """
    V = index.vocab_size
    N = index.n_docs_pad
    r = min(rank + oversample, min(V, N))
    dev = index.device
    w = index.postings_w              # (nnz,) tf-idf values (L2-normed docs)
    docs = index.postings_doc.long()
    terms = _term_of_posting(index).clamp(0, V - 1)
    # padding slots have w == 0, so they contribute nothing

    def a_mat(X):              # (V, k) -> (N, k):  A @ X
        out = torch.zeros((N, X.shape[1]), dtype=torch.float32, device=dev)
        return out.index_add_(0, docs, w[:, None] * X[terms])

    def at_mat(Y):             # (N, k) -> (V, k):  A^T @ Y
        out = torch.zeros((V, Y.shape[1]), dtype=torch.float32, device=dev)
        return out.index_add_(0, terms, w[:, None] * Y[docs])

    if start is None:
        start = torch.randn((V, r),
                            generator=torch.Generator().manual_seed(seed))
    G = torch.as_tensor(start, dtype=torch.float32).to(dev)
    if tuple(G.shape) != (V, r):
        raise ValueError(f"start matrix {tuple(G.shape)}, expected {(V, r)}")
    Y = a_mat(G)
    # power iterations sharpen the spectrum (randomized SVD standard)
    for _ in range(iters):
        Y, _ = torch.linalg.qr(Y)
        Y = a_mat(at_mat(Y))
    Q, _ = torch.linalg.qr(Y)                  # (N, r)
    B = at_mat(Q).T                            # (r, V)
    Ub, S, Vt = torch.linalg.svd(B, full_matrices=False)
    k = min(rank, S.shape[0])
    doc_emb = (Q @ Ub[:, :k]) * S[None, :k]
    return doc_emb, S[:k], Vt[:k]


@ieee_f32()
def project_queries(Vt: torch.Tensor, qids, qw) -> torch.Tensor:
    """Sparse query vectors → low-rank coordinates: (Q, rank)."""
    qids = torch.as_tensor(qids, device=Vt.device).long()
    qw = torch.as_tensor(qw, dtype=torch.float32, device=Vt.device)
    Vq = Vt.T[qids.clamp(0, Vt.shape[1] - 1)]          # (Q, T, rank)
    return torch.einsum("qtr,qt->qr", Vq, qw)


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """faiss.normalize_L2 equivalent."""
    return x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp_min(1e-9)
