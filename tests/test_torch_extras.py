"""The port's auxiliary learners against the JAX package, on CPU:
``LogisticRegressionRanker``, ``UnigramLanguageModel`` and the randomized
TF-IDF SVD (``tfidf_svd``, ``project_queries``, ``l2_normalize``).

Tolerances: the logistic ranker's weights within rtol 1e-5 (the same f32
GD, its sums in another order, 500-1000 epochs); the unigram log-probs
within 2 f32 ulps (``log`` of the same f32 probabilities, from the same
integer counts: XLA:CPU's polynomial against torch's).  ``tfidf_svd`` from
the JAX start matrix: the singular values within rtol 1e-4, and, with each
component's sign pinned (its largest |Vt| entry positive, on both sides),
``Vt`` and the doc coordinates within 1e-4 of their scale for the
components whose singular value stands 1e-3 (relative) clear of its
neighbours; a near-degenerate pair may rotate within its plane, so the
rank-k reconstruction ``doc_emb @ Vt`` is held for all of them.
"""

import numpy as np
import pytest

from tests.torch_threads import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tdr.index import build as jbuild  # noqa: E402
from tdr.models import extras as jextras  # noqa: E402
from tdr.ops import svd as jsvd  # noqa: E402
from tdr.text import build_vocab, encode_docs  # noqa: E402
from tdr.text.vocab import Vocab  # noqa: E402
from tdr.utils.config import IndexConfig  # noqa: E402
from tdr_torch.index import build as tbuild  # noqa: E402
from tdr_torch.models import extras as textras  # noqa: E402
from tdr_torch.ops import svd as tsvd  # noqa: E402
from tdr_torch.utils import config as tconfig  # noqa: E402

CFG = IndexConfig(doc_pad_multiple=8, nnz_pad_multiple=64,
                  head_budget_bytes=1 << 20, head_dtype="float32")


def _coo(seed, n_docs=240, vocab_n=400):
    """Seeded docs, term ids in order of first appearance: ``build_vocab``
    numbers them in ``set`` order, which follows each process's string-hash
    seed, and the randomized SVD pairs the start matrix's rows with ids."""
    rng = np.random.RandomState(seed)
    docs = [[f"t{int(rng.zipf(1.3)) % vocab_n}"
             for _ in range(rng.randint(3, 60))] for _ in range(n_docs)]
    v = build_vocab(docs)
    terms = list(dict.fromkeys(t for d in docs for t in d))
    vocab = Vocab({t: i for i, t in enumerate(terms)},
                  np.asarray([v.df[v.term_to_id[t]] for t in terms], np.int32),
                  v.n_docs)
    return vocab, encode_docs(docs, vocab)


def _indexes(kind, seed=0):
    vocab, coo = _coo(seed)
    tcfg = tconfig.IndexConfig(**{f: getattr(CFG, f)
                                  for f in CFG.__dataclass_fields__})
    jb = jbuild.build_tfidf_index if kind == "tfidf" else jbuild.build_index
    tb = tbuild.build_tfidf_index if kind == "tfidf" else tbuild.build_index
    return (vocab, jb(*coo, vocab.size, index_cfg=CFG),
            tb(*coo, vocab.size, index_cfg=tcfg, device="cpu"))


# -- logistic regression --------------------------------------------------------

@pytest.mark.parametrize("lr,epochs", [(0.5, 500), (0.01, 1000)])
def test_logreg_matches_jax(lr, epochs):
    rng = np.random.RandomState(0)
    X = rng.randn(200, 8).astype(np.float32)
    y = (X @ rng.randn(8) > 0).astype(np.float32)
    j = jextras.LogisticRegressionRanker(lr=lr, epochs=epochs).fit(X, y)
    t = textras.LogisticRegressionRanker(lr=lr, epochs=epochs,
                                         device="cpu").fit(X, y)
    np.testing.assert_allclose(t.w.numpy(), np.asarray(j.w), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(t.b.item(), float(j.b), rtol=1e-5, atol=1e-6)
    Xt = rng.randn(50, 8).astype(np.float32)
    np.testing.assert_allclose(t.predict_proba(Xt), j.predict_proba(Xt),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(t.rank(Xt, k=50), j.rank(Xt, k=50))


def test_logreg_rank_is_stable_and_needs_fit():
    X = np.array([[0.0], [1.0], [1.0], [2.0]], np.float32)
    clf = textras.LogisticRegressionRanker(lr=0.5, epochs=300, device="cpu")
    with pytest.raises(ValueError, match="fit first"):
        clf.predict_proba(X)
    clf.fit(X, np.array([0, 1, 1, 1], np.float32))
    assert clf.rank(X, k=4).tolist() == [3, 1, 2, 0]   # the tie keeps order


# -- unigram LM -------------------------------------------------------------------

@pytest.mark.parametrize("smoothing", [1.0, 0.5])
def test_unigram_lm_matches_jax(smoothing):
    vocab, jix, tix = _indexes("bm25")
    j = jextras.UnigramLanguageModel.from_index(jix, smoothing=smoothing)
    t = textras.UnigramLanguageModel.from_index(tix, smoothing=smoothing)
    jl = np.asarray(j.log_prob)
    np.testing.assert_allclose(t.log_prob.numpy(), jl, rtol=0,
                               atol=2 * np.spacing(np.abs(jl)).max())
    np.testing.assert_allclose(np.exp(t.log_prob.numpy()).sum(), 1.0,
                               rtol=1e-5)
    rng = np.random.RandomState(1)
    qids = rng.randint(0, vocab.size + 5, size=(30, 6)).astype(np.int32)
    qw = (rng.rand(30, 6) > 0.3).astype(np.float32) * rng.randint(
        1, 4, size=(30, 6)).astype(np.float32)
    js = j.score_queries(qids, qw)
    np.testing.assert_allclose(t.score_queries(qids, qw), js, rtol=1e-6,
                               atol=1e-5)


# -- randomized SVD -------------------------------------------------------------

def _pin(doc_emb, Vt):
    """Each component's sign fixed so that its largest |Vt| entry is
    positive (sklearn's ``svd_flip`` on V)."""
    s = np.sign(Vt[np.arange(Vt.shape[0]), np.abs(Vt).argmax(axis=1)])
    return doc_emb * s[None, :], Vt * s[:, None]


def _separated(S, rel=1e-3):
    gap = np.full(S.shape, np.inf)
    d = np.abs(np.diff(S))
    gap[:-1] = np.minimum(gap[:-1], d)
    gap[1:] = np.minimum(gap[1:], d)
    return gap > rel * S[0]


@pytest.mark.parametrize("rank,iters", [(8, 3), (48, 2)])
def test_tfidf_svd_matches_jax(rank, iters):
    vocab, jix, tix = _indexes("tfidf", seed=2)
    key = jax.random.PRNGKey(rank)
    r = min(rank + 16, min(jix.vocab_size, jix.n_docs_pad))
    G = np.asarray(jax.random.normal(key, (jix.vocab_size, r), jnp.float32))
    je, jS, jV = (np.asarray(x) for x in jsvd.tfidf_svd(jix, key, rank=rank,
                                                         iters=iters))
    te, tS, tV = (x.numpy() for x in tsvd.tfidf_svd(
        tix, torch.from_numpy(G.copy()), rank=rank, iters=iters))
    assert te.shape == je.shape and tV.shape == jV.shape
    np.testing.assert_allclose(tS, jS, rtol=1e-4, atol=1e-6)
    je, jV = _pin(je, jV)
    te, tV = _pin(te, tV)
    ok = _separated(jS)
    assert ok[:4].all()
    np.testing.assert_allclose(tV[ok], jV[ok], atol=1e-4 * np.abs(jV).max())
    np.testing.assert_allclose(te[:, ok], je[:, ok],
                               atol=1e-4 * np.abs(je).max())
    np.testing.assert_allclose(te @ tV, je @ jV, atol=1e-4 * np.abs(je @ jV).max())

    rng = np.random.RandomState(3)
    qids = rng.randint(0, vocab.size, size=(12, 5)).astype(np.int32)
    qw = rng.rand(12, 5).astype(np.float32)
    jq = np.asarray(jsvd.l2_normalize(jsvd.project_queries(
        jnp.asarray(jV), jnp.asarray(qids), jnp.asarray(qw))))
    tq = tsvd.l2_normalize(tsvd.project_queries(torch.from_numpy(jV.copy()), qids,
                                                qw)).numpy()
    np.testing.assert_allclose(tq, jq, rtol=1e-5, atol=1e-6)


def test_tfidf_svd_default_start_is_seeded():
    """Without a start matrix the port draws it from a CPU generator seeded
    with ``seed``: the same matrix on every device."""
    _, _, tix = _indexes("tfidf", seed=2)
    r = min(8 + 16, tix.vocab_size, tix.n_docs_pad)
    a = tsvd.tfidf_svd(tix, rank=8, seed=5)
    b = tsvd.tfidf_svd(tix, torch.randn(
        (tix.vocab_size, r), generator=torch.Generator().manual_seed(5)),
        rank=8)
    c = tsvd.tfidf_svd(tix, rank=8, seed=6)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[2], c[2])
    with pytest.raises(ValueError, match="start matrix"):
        tsvd.tfidf_svd(tix, torch.zeros(3, 3), rank=8)


def test_l2_normalize_zero_row():
    x = torch.tensor([[3.0, 4.0], [0.0, 0.0]])
    out = tsvd.l2_normalize(x).numpy()
    np.testing.assert_allclose(out, np.asarray(jsvd.l2_normalize(
        jnp.asarray(x.numpy()))), rtol=1e-6)
    assert np.isfinite(out).all()
