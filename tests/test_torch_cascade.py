"""The cosine → BM25 cascade, the single-index retriever and rank fusion in
the port against the JAX package, on CPU (mirrors
tests/test_router_extras.py).

The stage indexes are built by ``tdr`` and carried across, so a
difference is a scoring fault: re-ranked top-k within rtol 1e-6 (rows
exact but for near-ties); whole retrievers give the same docid lists but
for near-ties in their candidate sets.
"""

import numpy as np
import pytest

from tests.torch_threads import torch

import jax.numpy as jnp  # noqa: E402

from tdr.data import SyntheticSpec, synthetic_corpus  # noqa: E402
from tdr.index import build_index, build_tfidf_index  # noqa: E402
from tdr.rank import cascade as jcas  # noqa: E402
from tdr.rank.fuse import rrf_fuse as j_rrf  # noqa: E402
from tdr.text import build_vocab, encode_docs, encode_queries  # noqa: E402
from tdr.utils.config import IndexConfig  # noqa: E402
from tdr_torch.rank import cascade as tcas  # noqa: E402
from tdr_torch.rank.fuse import rrf_fuse as t_rrf  # noqa: E402
from tdr_torch.utils import config as tconfig  # noqa: E402
from test_torch_kernels import assert_same_topk, carry  # noqa: E402
from test_torch_score_modes import CUMSUM_ATOL  # noqa: E402

CFG = IndexConfig(doc_pad_multiple=128, nnz_pad_multiple=64,
                  head_budget_bytes=1 << 15, head_dtype="float32")


def _stages(seed=0, n_docs=500, vocab_n=800, n_q=24):
    rng = np.random.RandomState(seed)
    docs = [[f"t{rng.randint(vocab_n)}" for _ in range(rng.randint(5, 60))]
            for _ in range(n_docs)]
    vocab = build_vocab(docs)
    coo = encode_docs(docs, vocab)
    jc = build_tfidf_index(*coo, vocab.size, index_cfg=CFG, head_size=16)
    jr = build_index(*coo, vocab.size, index_cfg=CFG, head_size=16)
    queries = [list(docs[rng.randint(n_docs)][:6]) for _ in range(n_q)]
    qids, qw = encode_queries(queries, vocab, 16)
    idf = np.asarray(jc.stats.idf)
    qw1 = np.where(qw > 0, idf[qids] * qw, 0).astype(np.float32)
    return jc, jr, qids, qw1, qw


@pytest.mark.parametrize("C", [40, 200])
def test_cascade_score_topk_matches_jax(C):
    jc, jr, qids, qw1, qw2 = _stages()
    tc, tr = carry(jc), carry(jr)
    jv, jrows = jcas.cascade_score_topk(
        jc, jr, jnp.asarray(qids), jnp.asarray(qw1), jnp.asarray(qids),
        jnp.asarray(qw2), C=C, k=10, tail_budget=64,
        cand_engine="pallas_interpret", rank_engine="pallas_interpret")
    q = torch.from_numpy(qids)
    tv, trows = tcas.cascade_score_topk(
        tc, tr, q, torch.from_numpy(qw1), q, torch.from_numpy(qw2),
        C=C, k=10, tail_budget=64)
    assert_same_topk(tv, trows, jv, jrows, rtol=1e-6, atol=CUMSUM_ATOL)


@pytest.mark.parametrize("exact_pairs", [False, True])
def test_rerank_pairs_topk_matches_jax(exact_pairs):
    jc, jr, qids, qw1, qw2 = _stages(seed=3)
    tr = carry(jr)
    rng = np.random.RandomState(1)
    cand = np.stack([rng.choice(jr.n_docs, 50, replace=False)
                     for _ in range(qids.shape[0])]).astype(np.int32)
    vals1 = rng.rand(*cand.shape).astype(np.float32)
    vals1[:, 45:] = -np.inf                      # candidates past the stage
    jv, jrows = jcas.rerank_pairs_topk(
        jr, jnp.asarray(qids), jnp.asarray(qw2), jnp.asarray(cand),
        jnp.asarray(vals1), 10, tail_budget=64, tail_engine="pallas_interpret",
        exact_pairs=exact_pairs)
    tv, trows = tcas.rerank_pairs_topk(
        tr, torch.from_numpy(qids), torch.from_numpy(qw2),
        torch.from_numpy(cand).long(), torch.from_numpy(vals1), 10,
        tail_budget=64, exact_pairs=exact_pairs)
    assert_same_topk(tv, trows, jv, jrows, rtol=1e-6, atol=1e-6)


_CORPUS = {}


def _corpus():
    if not _CORPUS:
        from test_torch_router import _native_built_once

        _native_built_once()
        _CORPUS["c"] = synthetic_corpus(SyntheticSpec(
            n_docs=1200, n_queries=80, seed=7, hard=True,
            ref_proportions=False, langs=("en",)))
    return _CORPUS["c"]


def test_cascade_retriever_matches_jax():
    """The JAX bench's configuration at a small size: one fast-encode pass
    feeds both stage models (TfidfCosineModel, BM25Model)."""
    from tdr.models import sparse as jsparse
    from tdr.text.fast import fast_encode_corpus
    from tdr_torch.models import sparse as tsparse

    corpus, queries = _corpus()
    vocab, *coo = fast_encode_corpus(corpus.texts, ["en"] * len(corpus.texts))
    cfg = dict(head_budget_bytes=1 << 18)
    jcand = jsparse.TfidfCosineModel.from_coo(vocab, tuple(coo), corpus.docids,
                                              index_cfg=IndexConfig(**cfg))
    jrank = jsparse.BM25Model.from_coo(vocab, tuple(coo), corpus.docids,
                                       index_cfg=IndexConfig(**cfg))
    tcand = tsparse.TfidfCosineModel.from_coo(
        vocab, tuple(coo), corpus.docids, index_cfg=tconfig.IndexConfig(**cfg),
        device="cpu")
    trank = tsparse.BM25Model.from_coo(
        vocab, tuple(coo), corpus.docids, index_cfg=tconfig.IndexConfig(**cfg),
        device="cpu")
    assert trank.index.head_size < trank.index.vocab_size
    jr = jcas.CascadeRetriever({"en": jcand}, {"en": jrank}, candidates=60,
                               query_batch=32)
    tr = tcas.CascadeRetriever({"en": tcand}, {"en": trank}, candidates=60,
                               query_batch=32)
    jd = jr.retrieve(queries.queries, queries.langs, k=10)
    td = tr.retrieve(queries.queries, queries.langs, k=10)
    assert sum(a != b for a, b in zip(td, jd)) <= len(jd) // 20
    from tdr.eval import recall_at_k

    pos = queries.positive_docs
    assert abs(recall_at_k(td, pos, 10) - recall_at_k(jd, pos, 10)) <= 0.05
    assert recall_at_k(td, pos, 10) > 0.5


def test_single_index_retriever_matches_jax():
    from tdr.rank.single_index import SingleIndexRetriever as JSingle
    from tdr_torch.rank.single_index import SingleIndexRetriever as TSingle

    corpus, queries = synthetic_corpus(SyntheticSpec(
        n_docs=400, n_queries=40, seed=3, hard=False))
    cfg = dict(head_budget_bytes=1 << 16, head_dtype="float32")
    js = JSingle.build(corpus, index_cfg=IndexConfig(**cfg))
    ts = TSingle.build(corpus, index_cfg=tconfig.IndexConfig(**cfg),
                       device="cpu")
    langs = list(queries.langs)
    langs[0] = "xx"                      # unknown: detected, else wildcard
    js.query_batch = ts.query_batch = 16
    assert ts.retrieve(queries.queries, langs) == \
        js.retrieve(queries.queries, langs)


def test_rrf_copy_matches_jax():
    rng = np.random.RandomState(0)
    runs = [[[f"d{x}" for x in rng.choice(30, 10, replace=False)]
             for _ in range(6)] for _ in range(3)]
    assert t_rrf(runs, k=10) == j_rrf(runs, k=10)
    assert t_rrf(runs, k=5, weights=[1, 0.5, 2]) == \
        j_rrf(runs, k=5, weights=[1, 0.5, 2])
