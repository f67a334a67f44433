"""The port's sentence-BM25 → dense re-rank cascade
(``tdr_torch.rank.sentence``) against the JAX package's, on CPU.

Sentence splitting, ``candidate_union`` and the fusion helpers are host
numpy copies: equal, bit for bit.  Sentence indexes are built on each side
from the same texts; ``top_sentences`` agree under ``assert_same_topk``
(scores within rtol 1e-6 plus the tail sums' ``CUMSUM_ATOL``).  The cascade
runs on one set of encoder weights (a ``DualEncoder`` carried by
``encoder_state_from_flax``, a ``BertEncoder`` by ``bert_state_from_flax``):
its stage signals agree within those tolerances (similarities within
1e-5), and its lists are equal but for near-ties, where two documents'
scores on the JAX side lie within 1e-5 of each other.
"""

import dataclasses

import numpy as np
import pytest

from tests.torch_threads import torch

import flax  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tdr.data import SyntheticSpec, synthetic_corpus  # noqa: E402
from tdr.models import convert as jconv  # noqa: E402
from tdr.models import dense as jdense  # noqa: E402
from tdr.models import encoder as jenc  # noqa: E402
from tdr.rank import sentence as jsent  # noqa: E402
from tdr.text.preprocess import Preprocessor as JPreprocessor  # noqa: E402
from tdr.utils.config import DenseConfig as JDenseConfig  # noqa: E402
from tdr.utils.config import IndexConfig as JIndexConfig  # noqa: E402
from tdr_torch.models import convert as tconv  # noqa: E402
from tdr_torch.models import dense as tdense  # noqa: E402
from tdr_torch.models import encoder as tenc  # noqa: E402
from tdr_torch.rank import sentence as tsent  # noqa: E402
from tdr_torch.utils.config import DenseConfig, IndexConfig  # noqa: E402
from test_torch_dense import _native_built_once  # noqa: E402
from test_torch_kernels import assert_same_topk  # noqa: E402
from test_torch_score_modes import CUMSUM_ATOL  # noqa: E402

ICFG = dict(doc_pad_multiple=8, nnz_pad_multiple=64, head_budget_bytes=1 << 14)
DCFG = dict(vocab_size=1000, dim=64, max_len=32)
TOL = 1e-5

TEXTS = ["Alpha beta. Gamma delta.", "no dots at all", "trailing dot.",
         ". . leading dots.. and  doubled..", "", "  .  ", "one.two.three."]
DOCIDS = ["d0", "doc_1", "a_b_c", "x_", "_y", "e", "f_9"]


def _native():
    """Build both native tokenizers under one lock (pytest-xdist workers
    must not run a lazy ``make`` at the same time)."""
    _native_built_once()
    from tdr.text.fast import fast_available

    assert fast_available()


# -- host helpers -------------------------------------------------------------

def test_sentence_split_matches_jax():
    for t in TEXTS:
        assert tsent.split_into_sentences(t) == jsent.split_into_sentences(t)
    assert tsent.explode_corpus(DOCIDS, TEXTS) == \
        jsent.explode_corpus(DOCIDS, TEXTS)
    sids, _ = tsent.explode_corpus(DOCIDS, TEXTS)
    assert "a_b_c_0" in sids and "x__0" in sids
    for sid in sids + ["plain", "_3", "a__2"]:
        assert tsent.get_original_docid(sid) == jsent.get_original_docid(sid)
        assert tsent.sentence_id(sid, 4) == jsent.sentence_id(sid, 4)


def _signals(seed=0, n=5, M=12):
    """(vals, valid, sims, doc_idx) with a constant row, a row with
    nothing valid and a row with one valid entry."""
    rng = np.random.RandomState(seed)
    vals = rng.rand(n, M).astype(np.float32) * 10
    sims = rng.randn(n, M).astype(np.float32)
    valid = rng.rand(n, M) > 0.25
    vals[1] = 3.0
    sims[1] = -0.5
    valid[1] = True
    valid[2] = False
    valid[3] = False
    valid[3, 4] = True
    vals = np.where(valid, vals, -np.inf).astype(np.float32)
    doc_idx = rng.randint(0, 5, (n, M)).astype(np.int32)
    return vals, valid, sims, doc_idx


@pytest.mark.parametrize("seed", [0, 1])
def test_fusion_helpers_bit_equal(seed):
    vals, valid, sims, doc_idx = _signals(seed)
    for x in (vals, sims):
        a, b = tsent._minmax(x, valid), jsent._minmax(x, valid)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    base = np.where(valid, sims, 0.0)
    a = tsent.SentenceLmCascade._doc_evidence(base, valid, doc_idx)
    b = jsent.SentenceLmCascade._doc_evidence(base, valid, doc_idx)
    assert np.array_equal(a, b)
    for alpha in (0.0, 0.35, 1.0):
        for agg in (0.0, 0.4):
            a = tsent.SentenceLmCascade._fuse(vals, valid, sims, alpha, agg,
                                              doc_idx)
            b = jsent.SentenceLmCascade._fuse(vals, valid, sims, alpha, agg,
                                              doc_idx)
            assert a.dtype == b.dtype and np.array_equal(a, b), (alpha, agg)
    assert tsent.SentenceLmCascade._doc_evidence(
        np.zeros((0, 3), np.float32), np.zeros((0, 3), bool),
        np.zeros((0, 3), np.int32)).shape == (0, 3)


# -- sentence indexes ---------------------------------------------------------

_WORLD = {}


def _world():
    """A two-language corpus of multi-sentence docs, its queries, and the
    sentence indexes built on both sides (fast and Preprocessor paths)."""
    if not _WORLD:
        _native()
        corpus, queries = synthetic_corpus(SyntheticSpec(
            n_docs=160, n_queries=48, seed=7, hard=True,
            ref_proportions=False, langs=("en", "de"), sentences_per_doc=4))
        built = {}
        for lang in ("en", "de"):
            sel = [i for i, l in enumerate(corpus.langs) if l == lang]
            ids = [corpus.docids[i] for i in sel]
            texts = [corpus.texts[i] for i in sel]
            for fast in (True, False):
                j = jsent.SentenceBM25.build(
                    ids, texts, lang, index_cfg=JIndexConfig(**ICFG),
                    fast=fast)
                t = tsent.SentenceBM25.build(
                    ids, texts, lang, index_cfg=IndexConfig(**ICFG),
                    fast=fast, device="cpu")
                built[lang, fast] = (j, t)
        _WORLD.update(corpus=corpus, queries=queries, built=built)
    return _WORLD


@pytest.mark.parametrize("fast", [True, False])
def test_sentence_bm25_build_and_top_sentences(fast):
    w = _world()
    for lang in ("en", "de"):
        j, t = w["built"][lang, fast]
        assert t.model.docids == j.model.docids and t.texts == j.texts
        assert t.model.index.head_size < t.model.index.vocab_size  # tails
        pp = JPreprocessor("best")
        toks = [pp(q, lang) for q, l in zip(w["queries"].queries,
                                            w["queries"].langs) if l == lang]
        jv, js = j.top_sentences(toks, k=20)
        tv, ts = t.top_sentences(toks, k=20)
        jr = np.asarray([[j.model.docids.index(s) for s in r] + [-1] * (20 - len(r))
                         for r in js])
        tr = np.asarray([[t.model.docids.index(s) for s in r] + [-1] * (20 - len(r))
                         for r in ts])
        assert_same_topk(tv, tr, jv, jr, rtol=1e-6, atol=CUMSUM_ATOL)


@pytest.mark.parametrize("cap", [7, 10, 1000])
def test_candidate_union_exact(cap):
    w = _world()
    j, t = w["built"]["en", True]
    pp = JPreprocessor("best")
    toks = [pp(q, "en") for q, l in zip(w["queries"].queries,
                                        w["queries"].langs) if l == "en"]
    toks = toks[:16] + [[]]
    qids, qw = j.model.encode_query_tokens_np(toks)
    want = jsent.candidate_union(j.model, qids, qw, max_candidates=cap)
    got = tsent.candidate_union(t.model, qids, qw, max_candidates=cap)
    assert got.dtype == np.int32 and got.shape == (len(toks), cap)
    np.testing.assert_array_equal(got, want)
    assert (got[-1] == -1).all() and (got[:-1] >= 0).any(axis=1).all()
    if cap == 1000:
        assert (got == -1).any(axis=1).all()          # padded, not cut


# -- the cascade --------------------------------------------------------------

_DENSE = {}


def _dense(kind):
    """(tdr DenseModel, port DenseModel) over one set of weights."""
    if kind not in _DENSE:
        w = _world()
        texts, ids = w["corpus"].texts[:1], w["corpus"].docids[:1]
        if kind == "dual":
            jm, jp = jenc.init_encoder(JDenseConfig(**DCFG, depth=2, heads=4,
                                                    dtype="float32"), seed=5)
            params = jax.tree_util.tree_map(np.asarray,
                                            flax.linen.meta.unbox(jp))
            cfg = DenseConfig(**DCFG, depth=2, heads=4, dtype="float32")
            tm = tenc.DualEncoder(cfg)
            tm.load_state_dict(tenc.encoder_state_from_flax(params))
            jcfg = JDenseConfig(**DCFG, depth=2, heads=4, dtype="float32")
        else:
            bcfg = dict(vocab_size=DCFG["vocab_size"], dim=DCFG["dim"],
                        depth=2, heads=4, mlp_hidden=128, max_len=32)
            jm = jconv.BertEncoder(jconv.BertConfig(**bcfg))
            jp = jm.init(jax.random.PRNGKey(6), jnp.zeros((1, 8), jnp.int32),
                         jnp.ones((1, 8), jnp.int32))["params"]
            jp = jax.tree_util.tree_map(np.asarray, flax.linen.meta.unbox(jp))
            tm = tconv.BertEncoder(tconv.BertConfig(**bcfg))
            tm.load_state_dict(tconv.bert_state_from_flax(jp), strict=True)
            cfg, jcfg = DenseConfig(**DCFG), JDenseConfig(**DCFG)
        _DENSE[kind] = (jdense.DenseModel.build(jm, jp, jcfg, texts, ids),
                        tdense.DenseModel.build(tm.eval(), cfg, texts, ids))
    return _DENSE[kind]


def _cascades(kind, query_batch=128):
    w = _world()
    jd, td = _dense(kind)
    jmods, tmods = {}, {}
    for lang in ("en", "de"):
        j, t = w["built"][lang, True]
        # fresh wrappers: each cascade embeds its corpus itself
        jmods[lang] = jsent.SentenceBM25(j.model, j.texts)
        tmods[lang] = tsent.SentenceBM25(t.model, t.texts)
    return (jsent.SentenceLmCascade(jmods, jd, bm25_candidates=24,
                                    query_batch=query_batch),
            tsent.SentenceLmCascade(tmods, td, bm25_candidates=24,
                                    query_batch=query_batch))


def _eval_queries():
    """The queries with their languages; a few re-labelled "fr", which has
    no sentence index: they fall back to ``default_lang``."""
    w = _world()
    qs = list(w["queries"].queries)
    langs = list(w["queries"].langs)
    for i in range(0, len(langs), 7):
        langs[i] = "fr"
    return qs, langs, list(w["queries"].positive_docs)


def _doc_scores(chunks, n_queries, alpha, agg, stage1=False):
    """Per query, {docid: its best candidate score} on one side's stage
    signals: the fused score, or the stage-1 score."""
    out = [dict() for _ in range(n_queries)]
    for smodel, sel, vals, valid, sims, doc_idx in chunks:
        f = vals if stage1 else jsent.SentenceLmCascade._fuse(
            vals, valid, sims, alpha, agg, doc_idx)
        for r, qi in enumerate(sel):
            for m in np.nonzero(valid[r])[0]:
                d = smodel.doc_table[doc_idx[r, m]]
                out[qi][d] = max(out[qi].get(d, -np.inf), float(f[r, m]))
    return out


def _assert_lists_near(got, want, scores):
    """Equal lists but where the JAX side's two documents at a rank score
    within TOL of each other."""
    assert len(got) == len(want)
    for q, (a, b) in enumerate(zip(got, want)):
        assert len(a) == len(b), f"query {q}: {len(a)} vs {len(b)} docs"
        for r, (x, y) in enumerate(zip(a, b)):
            if x != y:
                sx, sy = scores[q].get(x, -np.inf), scores[q][y]
                assert np.isclose(sx, sy, rtol=TOL, atol=TOL), \
                    f"query {q} rank {r}: {x} {sx} vs {y} {sy}"


def _assert_same_stages(tchunks, jchunks):
    """Stage-1 scores within their tolerance; the similarities within TOL
    at every slot outside a stage-1 near-tie (whose two sentences either
    side may order otherwise)."""
    assert len(tchunks) == len(jchunks)
    for t, j in zip(tchunks, jchunks):
        assert t[1] == j[1]                                   # same queries
        np.testing.assert_array_equal(t[3], j[3])             # valid
        jv = j[2]
        fin = np.isfinite(jv)
        np.testing.assert_allclose(t[2][fin], jv[fin], rtol=1e-6,
                                   atol=CUMSUM_ATOL)
        tied = np.isclose(jv[:, :, None], jv[:, None, :], rtol=1e-6,
                          atol=CUMSUM_ATOL).sum(axis=2) >= 2
        same = fin & ~tied
        assert same.sum() > fin.sum() // 2
        np.testing.assert_allclose(t[4][same], j[4][same], rtol=0, atol=TOL)


@pytest.mark.parametrize("kind", ["dual", "bert"])
def test_cascade_retrieve_matches_jax(kind):
    qs, langs, _ = _eval_queries()
    jc, tc = _cascades(kind)
    jchunks = jc._run_stages(qs, langs)
    _assert_same_stages(tc._run_stages(qs, langs), jchunks)
    assert isinstance(tc.sentence_models["en"].embeddings, torch.Tensor)
    np.testing.assert_allclose(
        tc.sentence_models["de"].embeddings.numpy(),
        jc.sentence_models["de"].embeddings, rtol=0, atol=TOL)
    fused = _doc_scores(jchunks, len(qs), jc.fusion_alpha, jc.doc_agg_weight)
    first = _doc_scores(jchunks, len(qs), 1.0, 0.0, stage1=True)
    jres, js1 = jc.retrieve(qs, langs, k=10, with_stage1=True)
    tres, ts1 = tc.retrieve(qs, langs, k=10, with_stage1=True)
    _assert_lists_near(tres, jres, fused)
    _assert_lists_near(ts1, js1, first)
    plain = tc.retrieve(qs, langs, k=10)
    assert plain == tres and max(len(r) for r in plain) == 10
    assert max(len(r) for r in ts1) > 10               # the full stage-1 list


def test_cascade_query_batch_does_not_change_lists():
    qs, langs, _ = _eval_queries()
    _, small = _cascades("bert", query_batch=4)
    _, big = _cascades("bert", query_batch=256)
    assert small.retrieve(qs, langs, k=10, with_stage1=True) == \
        big.retrieve(qs, langs, k=10, with_stage1=True)
    assert small.retrieve([], [], k=10, with_stage1=True) == ([], [])


@pytest.mark.parametrize("kind", ["dual", "bert"])
def test_tune_fusion_alpha_matches_jax(kind):
    qs, langs, pos = _eval_queries()
    jc, tc = _cascades(kind)
    ja, jcurve = jc.tune_fusion_alpha(qs, langs, pos, k=10)
    ta, tcurve = tc.tune_fusion_alpha(qs, langs, pos, k=10)
    assert (ta, tc.doc_agg_weight) == (ja, jc.doc_agg_weight)
    assert tcurve == jcurve and len(tcurve) == 28
    # alpha = 1 without doc evidence is the stage-1 order (monotone minmax)
    _, s1 = tc.retrieve(qs, langs, k=10, with_stage1=True)
    t1 = dataclasses.replace(tc, fusion_alpha=1.0, doc_agg_weight=0.0)
    assert t1.retrieve(qs, langs, k=10) == [r[:10] for r in s1]


def test_sentence_index_needs_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsent.SentenceBM25.build(DOCIDS, TEXTS, "en", fast=False)
    t = tsent.SentenceBM25.build(DOCIDS, TEXTS, "en", fast=False,
                                 device="cpu")
    assert t.model.device.type == "cpu" and len(t.texts) == 9
