"""The port's vocab-axis TP engine against ``tdr/parallel/vocab_tp.py`` on
CPU: the pure-matmul TP of a full-vocab head, the hybrid (sharded head +
replicated tail, the port's tail engine K1 in its plain version here, where
``tdr`` sorts), the int8 head and the overflow fallback.

Both packages get the same index arrays: the port's index is carried from
``tdr``'s through ``sparse_index_from_arrays``.  ``tdr`` runs on its 8
virtual CPU devices, the port on a mesh of ``"cpu"`` entries.  Tolerances
are ``tests/test_vocab_tp.py``'s: 1e-5 (int8 1e-4), and rows equal wherever
the margin to the next rank beats 1e-4.
"""

import numpy as np
import pytest

from tests.torch_threads import torch

import jax.numpy as jnp  # noqa: E402

from tdr.data import SyntheticSpec, synthetic_corpus  # noqa: E402
from tdr.index import build_index, quantize_head  # noqa: E402
from tdr.parallel import make_mesh as j_make_mesh  # noqa: E402
from tdr.parallel import vocab_tp as jtp  # noqa: E402
from tdr.text import (build_vocab, encode_docs, encode_queries,  # noqa: E402
                      preprocess_texts)
from tdr.utils.config import IndexConfig  # noqa: E402
from tdr_torch.index.build import sparse_index_from_arrays  # noqa: E402
from tdr_torch.ops.score import score_and_topk_fused  # noqa: E402
from tdr_torch.parallel import vocab_tp as ttp  # noqa: E402
from test_torch_parallel import cpu_mesh  # noqa: E402

FULL = IndexConfig(doc_pad_multiple=8, nnz_pad_multiple=64,
                   head_budget_bytes=1 << 30, head_dtype="float32")
TINY = IndexConfig(doc_pad_multiple=8, nnz_pad_multiple=64,
                   head_budget_bytes=1 << 12)


def carry(index):
    """The port's copy of a ``tdr`` index, array for array."""
    from tdr.ckpt.registry import _to_numpy_savable

    arrays, dtypes = {}, {}
    for name in ("indptr", "postings_doc", "postings_w", "postings_tf",
                 "head_slot", "head_rows"):
        arrays[name], dtypes[name] = _to_numpy_savable(getattr(index, name))
    if index.head_scale is not None:
        arrays["head_scale"], dtypes["head_scale"] = _to_numpy_savable(
            index.head_scale)
    for name in ("df", "idf", "doc_len", "avgdl"):
        arrays[f"stats_{name}"], dtypes[f"stats_{name}"] = _to_numpy_savable(
            getattr(index.stats, name))
    statics = {k: int(getattr(index, k)) for k in (
        "n_docs", "n_docs_pad", "vocab_size", "tail_pmax", "head_size")}
    return sparse_index_from_arrays(arrays, {"statics": statics,
                                             "dtypes": dtypes}, device="cpu")


def _world(seed, cfg):
    corpus, queries = synthetic_corpus(
        SyntheticSpec(n_docs=300, n_queries=24, seed=seed,
                      ref_proportions=False, langs=("en",)))
    toks = preprocess_texts(corpus.texts, corpus.langs)
    vocab = build_vocab(toks)
    coo = encode_docs(toks, vocab)
    qids, qw = encode_queries(preprocess_texts(queries.queries, queries.langs),
                              vocab, max_terms=16)
    return build_index(*coo, vocab.size, index_cfg=cfg), qids, qw


@pytest.fixture(scope="module")
def world():
    index, qids, qw = _world(23, FULL)
    assert index.head_size >= index.vocab_size, "fixture must be full-head"
    return index, qids, qw


@pytest.fixture(scope="module")
def tail_world():
    index, qids, qw = _world(3, TINY)
    assert 0 < index.head_size < index.vocab_size
    return index, qids, qw


def assert_tp_topk(tv, tr, jv, jr, tol=1e-5):
    tv, tr, jv, jr = (np.asarray(x) for x in (tv, tr, jv, jr))
    np.testing.assert_allclose(tv, jv, rtol=tol, atol=tol)
    margin_ok = np.abs(jv - np.roll(jv, -1, axis=1)) > 1e-4
    same = (tr == jr) | ~np.isfinite(jv)
    assert (same | ~margin_ok)[:, :-1].all()


def _both(index, qids, qw, n_shards, top_k=10):
    vj = jtp.vocab_shard_index(index, n_shards)
    jv, jr = jtp.vocab_tp_score_topk(j_make_mesh(data=1, model=n_shards), vj,
                                     jnp.asarray(qids), jnp.asarray(qw),
                                     top_k=top_k)
    vt = ttp.vocab_shard_index(carry(index), n_shards, ["cpu"] * n_shards)
    tv, tr = ttp.vocab_tp_score_topk(cpu_mesh(1, n_shards), vt,
                                     torch.from_numpy(np.asarray(qids)),
                                     torch.from_numpy(np.asarray(qw)),
                                     top_k=top_k)
    return vj, vt, (tv, tr, jv, jr)


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_pure_tp_matches_tdr(world, n_shards):
    index, qids, qw = world
    vj, vt, res = _both(index, qids, qw, n_shards)
    assert vt.tail_index is None and vt.d_local == vj.d_local
    assert len(vt.head_rows) == n_shards
    assert tuple(vt.head_rows[0].shape) == tuple(vj.head_rows.shape[1:])
    assert_tp_topk(*res)


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_hybrid_tp_matches_tdr(tail_world, n_shards):
    index, qids, qw = tail_world
    vj, vt, res = _both(index, qids, qw, n_shards)
    assert vt.tail_index is not None
    # the replicated tail carries no head rows
    assert vt.tail_index[0].head_rows.numel() == 0
    assert vt.per_device_bytes()["head_shard_bytes"] == \
        vj.per_device_bytes()["head_shard_bytes"]
    assert_tp_topk(*res)


def test_hybrid_tp_int8_matches_tdr(tail_world):
    """int8 head: the partials sum as exact integers and each device
    dequantizes its own slice after the collective."""
    index, qids, qw = tail_world
    _, vt, res = _both(quantize_head(index), qids, qw, 4)
    assert vt.head_rows[0].dtype == torch.int8 and len(vt.head_scale) == 4
    assert_tp_topk(*res, tol=1e-4)


def test_hybrid_tp_overflow_matches_tdr(tail_world):
    """More tail terms in one query than the compaction keeps: the exact
    in-range scatter runs on every device."""
    index, _, _ = tail_world
    tail_terms = np.where(np.asarray(index.head_slot) < 0)[0]
    tail_terms = tail_terms[np.asarray(index.stats.df)[tail_terms] > 0][:24]
    assert tail_terms.size >= 20
    qids = tail_terms[None, :].astype(np.int32)
    qw = np.ones((1, tail_terms.size), np.float32)
    _, _, res = _both(index, qids, qw, 4)
    assert_tp_topk(*res)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_layout_equals_materialised(tail_world, n_shards):
    """``vocab_shard_layout``'s arithmetic equals the materialised
    per-device bytes exactly (the stripped tail holds only what its scorer
    reads), and its head figure equals ``tdr``'s."""
    index, _, _ = tail_world
    t_index = carry(index)
    for ix, tix in ((index, t_index), (quantize_head(index), None)):
        tix = tix if tix is not None else carry(ix)
        got = ttp.vocab_shard_index(tix, n_shards).per_device_bytes()
        want = ttp.vocab_shard_layout(tix, n_shards)
        for key in ("head_shard_bytes", "replicated_tail_bytes",
                    "replicated_slot_bytes", "total_per_device_bytes"):
            assert got[key] == want[key], key
        assert want == jtp.vocab_shard_layout(ix, n_shards)


def test_vocab_tp_deterministic(tail_world):
    index, qids, qw = tail_world
    vt = ttp.vocab_shard_index(carry(index), 4)
    q, w = torch.from_numpy(qids), torch.from_numpy(qw)
    v1, r1 = ttp.vocab_tp_score_topk(cpu_mesh(1, 4), vt, q, w, top_k=10)
    v2, r2 = ttp.vocab_tp_score_topk(cpu_mesh(1, 4), vt, q, w, top_k=10)
    assert torch.equal(v1, v2) and torch.equal(r1, r2)


@pytest.mark.parametrize("which", ["full", "tail"])
def test_vocab_tp_matches_port_single_device(world, tail_world, which):
    """The port's TP engine against the port's single-device fused engine
    on the same index."""
    index, qids, qw = world if which == "full" else tail_world
    t_index = carry(index)
    q, w = torch.from_numpy(qids), torch.from_numpy(qw)
    v1, r1 = score_and_topk_fused(t_index, q, w, top_k=10)
    vt = ttp.vocab_shard_index(t_index, 4)
    tv, tr = ttp.vocab_tp_score_topk(cpu_mesh(1, 4), vt, q, w, top_k=10)
    assert_tp_topk(tv, tr, v1, r1)


def test_router_mixes_vocab_tp_model():
    """A ``LanguageRouter`` serving en from a vocab-TP model and fr from a
    single-device one: every list equals the single-device router's but
    for near-ties."""
    from tdr_torch.models.sparse import BM25Model
    from tdr_torch.rank import LanguageRouter, build_language_models
    from tdr_torch.utils import config as tconfig

    corpus, queries = synthetic_corpus(
        SyntheticSpec(n_docs=240, n_queries=24, seed=29, ref_proportions=False,
                      langs=("en", "fr")))
    models = build_language_models(
        corpus, BM25Model, index_cfg=tconfig.IndexConfig(
            doc_pad_multiple=8, nnz_pad_multiple=64,
            head_budget_bytes=1 << 30, head_dtype="float32"),
        use_native=False, device="cpu")
    mixed = dict(models)
    mixed["en"] = ttp.VocabTpBM25Model.from_model(models["en"], cpu_mesh(1, 4))
    b_docs, b_scores = LanguageRouter(models, query_batch=8, use_native=False
                                      ).retrieve_with_scores(
        queries.queries, queries.langs, k=10)
    g_docs, g_scores = LanguageRouter(mixed, query_batch=8, use_native=False
                                      ).retrieve_with_scores(
        queries.queries, queries.langs, k=10)
    np.testing.assert_allclose(g_scores, b_scores, rtol=1e-5, atol=1e-5)
    for q, (a, b) in enumerate(zip(g_docs, b_docs)):
        for j in np.nonzero(np.array(a) != np.array(b))[0]:
            assert np.isclose(b_scores[q], b_scores[q, j], rtol=1e-5,
                              atol=1e-5).sum() >= 2, f"query {q} rank {j}"
