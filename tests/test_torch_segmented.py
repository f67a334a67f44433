"""The segment store (``SegmentedBM25``) in the port against the JAX
package, on CPU (mirrors tests/test_segmented.py): adds, deletes,
re-adds, the tombstone margins, store-level PRF and compaction.

Both stores wrap a main segment built from the same documents; results
must be equal: rows exact (but for near-ties), scores within rtol 1e-6
plus the tail sums' cumsum rounding (``CUMSUM_ATOL``).
"""

import numpy as np
import pytest

from tests.torch_threads import torch

from tdr.models import BM25Model as JBM25  # noqa: E402
from tdr.rank.segmented import SegmentedBM25 as JSeg  # noqa: E402
from tdr.utils.config import IndexConfig  # noqa: E402
from tdr_torch.models.sparse import BM25Model as TBM25  # noqa: E402
from tdr_torch.rank.segmented import SegmentedBM25 as TSeg  # noqa: E402
from tdr_torch.utils import config as tconfig  # noqa: E402
from test_torch_kernels import assert_same_topk  # noqa: E402
from test_torch_score_modes import CUMSUM_ATOL  # noqa: E402

CFG = dict(doc_pad_multiple=8, nnz_pad_multiple=64, head_budget_bytes=1 << 15,
           head_dtype="float32")


def _docs(seed, n, vocab_n=400, prefix="t"):
    rng = np.random.RandomState(seed)
    return [[f"{prefix}{rng.randint(vocab_n)}" for _ in range(rng.randint(5, 50))]
            for _ in range(n)]


def _stores(n_main=300):
    docs = _docs(1, n_main)
    ids = [f"d{i}" for i in range(n_main)]
    jcfg, tcfg = IndexConfig(**CFG), tconfig.IndexConfig(**CFG)
    js = JSeg(main=JBM25.build(docs, ids, index_cfg=jcfg), index_cfg=jcfg)
    ts = TSeg(main=TBM25.build(docs, ids, index_cfg=tcfg, device="cpu"),
              index_cfg=tcfg)
    return docs, js, ts


def _queries(docs, seed=2, n=24):
    rng = np.random.RandomState(seed)
    return [list(docs[rng.randint(len(docs))][:4]) for _ in range(n)]


def _same(js, ts, queries, k=10):
    jv, jr = js.topk_tokens(queries, k)
    tv, tr = ts.topk_tokens(queries, k)
    assert_same_topk(tv, tr, jv, jr, rtol=1e-6, atol=CUMSUM_ATOL)
    assert js.docids == ts.docids
    assert js.truncated_queries == ts.truncated_queries
    return tv, tr


def _both(stores, method, *args):
    for s in stores:
        getattr(s, method)(*args)


def test_delta_index_matches_jax():
    """The delta built against global statistics (idf injected, avgdl
    over both segments) is the JAX delta array for array."""
    docs, js, ts = _stores()
    new = _docs(7, 40, prefix="u") + [docs[0][:5]]
    _both((js, ts), "add_documents", new, [f"n{i}" for i in range(len(new))])
    j, t = js.delta.index, ts.delta.index
    for f in ("n_docs", "n_docs_pad", "vocab_size", "tail_pmax", "head_size"):
        assert getattr(j, f) == getattr(t, f), f
    for f in ("indptr", "postings_doc", "head_slot"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)))
    for f in ("postings_w", "head_rows"):
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(j, f)), rtol=1e-6)
    np.testing.assert_allclose(t.stats.idf.numpy(), np.asarray(j.stats.idf),
                               rtol=1e-6)
    np.testing.assert_allclose(float(t.stats.avgdl), float(j.stats.avgdl),
                               rtol=1e-6)


@pytest.mark.parametrize("n_dead", [0, 20, 100, 250])
def test_add_delete_readd_matches_jax(n_dead):
    """Each tombstone bucket (margin 0, 64, 256, 1024) through K1/K2's
    callers; re-added docids shadow their old copies."""
    docs, js, ts = _stores()
    new = _docs(8, 30, prefix="t")
    ids = [f"n{i}" for i in range(30)]
    _both((js, ts), "add_documents", new, ids)
    dead = [f"d{i}" for i in range(0, 300, 3)][:n_dead // 2] + \
        [f"n{i}" for i in range(n_dead - n_dead // 2)][:30]
    _both((js, ts), "delete_documents", dead + ["nope"])
    assert js._k_seg(10) == ts._k_seg(10)
    q = _queries(docs) + _queries(new, seed=5, n=8)
    _, tr = _same(js, ts, q)
    assert not set(np.asarray(tr).ravel().tolist()) & ts._dead_rows or \
        n_dead == 0
    _both((js, ts), "add_documents", [docs[3], new[0]], ["d3", "n0"])
    _same(js, ts, q)
    _same(js, ts, q[:1])                              # the gather head
    assert js.should_compact == ts.should_compact


@pytest.mark.parametrize("delta", [False, True])
def test_store_prf_matches_jax(delta):
    docs, js, ts = _stores()
    if delta:
        new = _docs(9, 40, prefix="t")
        _both((js, ts), "add_documents", new, [f"n{i}" for i in range(40)])
        _both((js, ts), "delete_documents", ["d1", "d2", "n3"])
    js.prf = ts.prf = True
    q = _queries(docs, seed=11)
    tv, _ = _same(js, ts, q)
    ts.prf = False
    assert not np.array_equal(ts.topk_tokens(q, 10)[0], tv)


def test_compact_and_router_protocol():
    from tdr_torch.rank import LanguageRouter

    docs, js, ts = _stores(n_main=200)
    new = _docs(4, 10)
    _both((js, ts), "add_documents", new, [f"n{i}" for i in range(10)])
    _both((js, ts), "delete_documents", ["d5"])
    all_docs = docs + new
    all_ids = [f"d{i}" for i in range(200)] + [f"n{i}" for i in range(10)]
    _both((js, ts), "compact_with", all_docs, all_ids)
    assert ts.delta is None and ts.main.index.n_docs == 209
    q = _queries(all_docs, seed=6)
    _same(js, ts, q)
    with pytest.raises(NotImplementedError):
        ts.compact()
    # a store serves inside the router through its sync topk_tokens
    r = LanguageRouter({"en": ts}, use_native=False, detect_missing_lang=False)
    got = r.retrieve([" ".join(x) for x in q[:3]], ["en"] * 3)
    assert [len(g) for g in got] == [10, 10, 10]
