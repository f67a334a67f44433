"""Pseudo-relevance feedback and spell repair in the port against the JAX
package, on CPU (mirrors tests/test_feedback.py and tests/test_spell.py).

The doc-major mirror and the mined terms and counts must be equal; pooled
totals and expansion weights within rtol 1e-5 (XLA's fused rounding, see
the tests); whole PRF passes return the
same top-k (scores within rtol 1e-6 plus the tail sums' cumsum rounding,
``CUMSUM_ATOL``, as in test_torch_score_modes.py; ranks equal but for
near-ties).

The vocabularies here give term ids in order of first appearance
(``_vocab``).  ``build_vocab`` numbers terms in ``set`` order, which follows
the process's string-hash seed, so every pytest-xdist worker saw other ids.
Under some of them (and under first appearance) a near-tie sat at the edge
of the top-E expansion choice, and the TF-IDF posting weights of the two
builds, an ulp apart, tipped it: a whole PRF pass appended another term.
The port's build then took ``rsqrt`` in two f32 roundings and XLA:CPU takes
it from the CPU's approximate instruction; it now rounds the f64 value once
(``test_torch_build.py`` holds the build).  ``test_model_knobs_match_jax``
runs each side on its own index; ``test_tfidf_prf_matches_jax_any_ids``
runs other id orders, its expansion check on the JAX-built index
(``_models(same_index=True)``) so that it isolates the feedback step.
"""

import dataclasses

import numpy as np
import pytest

from tests.torch_threads import torch

import jax.numpy as jnp  # noqa: E402

from tdr.index import build_index  # noqa: E402
from tdr.models import sparse as jsparse  # noqa: E402
from tdr.rank import feedback as jfb  # noqa: E402
from tdr.text import build_vocab, encode_docs  # noqa: E402
from tdr.text.vocab import Vocab  # noqa: E402
from tdr.text.spell import TrigramRepairer as JRepairer  # noqa: E402
from tdr.utils.config import IndexConfig  # noqa: E402
from tdr_torch.models import sparse as tsparse  # noqa: E402
from tdr_torch.rank import feedback as tfb  # noqa: E402
from tdr_torch.text.spell import TrigramRepairer as TRepairer  # noqa: E402
from tdr_torch.utils import config as tconfig  # noqa: E402
from test_torch_kernels import assert_same_topk, carry  # noqa: E402
from test_torch_score_modes import CUMSUM_ATOL  # noqa: E402

CFG = dict(doc_pad_multiple=8, nnz_pad_multiple=64, head_budget_bytes=1 << 14,
           head_dtype="float32")


def _docs(seed, n_docs=160, vocab_n=300):
    rng = np.random.RandomState(seed)
    return [[f"t{rng.randint(vocab_n)}" for _ in range(rng.randint(5, 60))]
            for _ in range(n_docs)]


def _vocab(docs, perm_seed=None):
    """``build_vocab``'s terms and dfs with ids in order of first appearance
    (the same in every process), or in a seeded random order."""
    v = build_vocab(docs)
    terms = list(dict.fromkeys(t for d in docs for t in d))
    if perm_seed is not None:
        terms = [terms[i] for i in np.random.RandomState(perm_seed).permutation(
            len(terms))]
    df = np.asarray([v.df[v.term_to_id[t]] for t in terms], np.int32)
    return Vocab({t: i for i, t in enumerate(terms)}, df, v.n_docs)


def _models(docs, cls="BM25Model", perm_seed=None, same_index=False, **cfg):
    """The JAX and the port's model over one vocabulary; ``same_index``
    gives the port the JAX-built index (``carry``), so that what is
    compared is the scoring and feedback, not the build's rounding."""
    vocab = _vocab(docs, perm_seed)
    coo = encode_docs(docs, vocab)
    ids = [f"d{i}" for i in range(len(docs))]
    c = {**CFG, **cfg}
    jm = getattr(jsparse, cls).from_coo(vocab, coo, ids,
                                        index_cfg=IndexConfig(**c))
    tm = getattr(tsparse, cls).from_coo(vocab, coo, ids,
                                        index_cfg=tconfig.IndexConfig(**c),
                                        device="cpu")
    if same_index:
        tm = dataclasses.replace(tm, index=carry(jm.index))
    return jm, tm


def _same_dmi(jd, td):
    np.testing.assert_array_equal(td.terms.numpy(), np.asarray(jd.terms))
    np.testing.assert_array_equal(td.w.numpy().view(np.int32),
                                  np.asarray(jd.w).view(np.int32))
    np.testing.assert_array_equal(td.doc_start.numpy(), np.asarray(jd.doc_start))
    assert td.p_doc == jd.p_doc


@pytest.mark.parametrize("case", ["random", "outlier_wide_doc"])
def test_doc_major_matches_jax(case):
    if case == "random":
        docs = _docs(3)
    else:   # one 1,500-term doc: truncated to MAX_P_DOC of its terms
        docs = [[f"w{j}" for j in range(1500)]] + [[f"a{i}_{j}" for j in range(5)]
                                                   for i in range(30)]
    vocab = _vocab(docs)
    coo = encode_docs(docs, vocab)
    j = build_index(*coo, vocab.size, index_cfg=IndexConfig(**CFG), head_size=16)
    _same_dmi(jfb.build_doc_major(j), tfb.build_doc_major(carry(j)))


def _mine_inputs(seed=5, Q=12, F=4):
    docs = _docs(seed)
    jm, tm = _models(docs)
    rng = np.random.RandomState(seed)
    queries = [list(docs[rng.randint(len(docs))][:3]) for _ in range(Q)]
    qids, qw = jm.encode_query_tokens_np(queries)
    fb_vals, fb_rows = jm._score_encoded(jnp.asarray(qids), jnp.asarray(qw), F)
    fb_vals, fb_rows = np.array(fb_vals), np.array(fb_rows)
    fb_vals[0] = -np.inf                         # a query with no feedback
    fb_vals[1, 2:] = 0.0                         # and one with two docs
    return jm, tm, qids, qw, fb_vals, fb_rows


@pytest.mark.parametrize("clamp,min_docs", [(1, 2), (1, 1), (2, 1)])
def test_prf_mine_matches_jax(clamp, min_docs):
    jm, tm, qids, qw, fb_vals, fb_rows = _mine_inputs()
    F = fb_vals.shape[1]
    jw_d, jfin = jfb.relevance_doc_weights(jnp.asarray(fb_vals), F)
    tw_d, tfin = tfb.relevance_doc_weights(torch.from_numpy(fb_vals), F)
    np.testing.assert_allclose(tw_d.numpy(), np.asarray(jw_d), rtol=1e-6)
    np.testing.assert_array_equal(tfin.numpy(), np.asarray(jfin))
    kw = dict(n_expand=8, min_docs=min_docs, count_rank_clamp=clamp)
    jt, jtot, jc = jfb.prf_mine(jm._doc_major(), jm.index.vocab_size,
                                jnp.asarray(qids), jnp.asarray(qw), jw_d,
                                jnp.asarray(fb_rows), jfin, **kw)
    tt, ttot, tc = tfb.prf_mine(tm._doc_major(), tm.index.vocab_size,
                                torch.from_numpy(qids), torch.from_numpy(qw),
                                tw_d, torch.from_numpy(fb_rows), tfin, **kw)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    fin = np.isfinite(np.asarray(jtot))
    np.testing.assert_array_equal(np.isfinite(ttot.numpy()), fin)
    # the totals follow XLA's cumsum order (ops/scan.py), but inside
    # prf_mine's jit, with the suite's 8 host devices, XLA rounds a few
    # fused products otherwise (1.6e-6 relative seen): rtol 1e-5
    np.testing.assert_allclose(ttot.numpy()[fin], np.asarray(jtot)[fin],
                               rtol=1e-5)
    assert fin.sum() > 20 and not fin[0].any()


@pytest.mark.parametrize("beta", [0.3, 0.7])
def test_prf_expand_matches_jax(beta):
    jm, tm, qids, qw, fb_vals, fb_rows = _mine_inputs(seed=7)
    kw = dict(n_expand=5, n_feedback=3, beta=beta, min_docs=2)
    jq, jw = jfb.prf_expand(jm._doc_major(), jm.index.vocab_size,
                            jnp.asarray(qids), jnp.asarray(qw),
                            jnp.asarray(fb_vals), jnp.asarray(fb_rows), **kw)
    tq, tw = tfb.prf_expand(tm._doc_major(), tm.index.vocab_size,
                            torch.from_numpy(qids), torch.from_numpy(qw),
                            torch.from_numpy(fb_vals), torch.from_numpy(fb_rows),
                            **kw)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    # tdr runs prf_expand as one jit: with the test suite's 8 host devices
    # XLA rounds one fused product otherwise (3e-6 relative in 1 of 828
    # weights), though prf_mine's totals and scale_expansion alone are
    # bit-equal (test_prf_mine_matches_jax)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5)
    assert tq.shape[1] == qids.shape[1] + 5 and (tw[:, -5:] > 0).any()


def _knob_queries(docs):
    rng = np.random.RandomState(4)
    queries = [list(docs[rng.randint(len(docs))][:4]) for _ in range(20)]
    for q in queries[::3]:                        # typos: drop one letter
        q[0] = q[0][:1] + q[0][2:]
    return queries


@pytest.mark.parametrize("perm_seed", [0, 1, 2, 3, 4, 5])
def test_tfidf_prf_matches_jax_any_ids(perm_seed):
    """The TF-IDF PRF case of ``test_model_knobs_match_jax`` under other
    term-id orders (as other hash seeds gave them): the same expansion from
    the same index and first pass, and the same whole PRF pass with each
    side on its own index."""
    docs = _docs(9, n_docs=240)
    jm, tm = _models(docs, "TfidfCosineModel", perm_seed=perm_seed,
                     same_index=True)
    queries = _knob_queries(docs)
    qids, qw = jm.encode_query_tokens_np(queries)
    fb_vals, fb_rows = jm._score_encoded(jnp.asarray(qids), jnp.asarray(qw), 3)
    kw = dict(n_expand=5, n_feedback=3, beta=0.3, min_docs=2)
    jq, jw = jfb.prf_expand(jm._doc_major(), jm.index.vocab_size,
                            jnp.asarray(qids), jnp.asarray(qw), fb_vals,
                            fb_rows, **kw)
    tq, tw = tfb.prf_expand(tm._doc_major(), tm.index.vocab_size,
                            torch.from_numpy(qids), torch.from_numpy(qw),
                            torch.from_numpy(np.array(fb_vals)),
                            torch.from_numpy(np.array(fb_rows)), **kw)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5)
    jm, tm = (dataclasses.replace(m, prf=True) for m in
              _models(docs, "TfidfCosineModel", perm_seed=perm_seed))
    jv, jr = jm.topk_tokens(queries, 10)
    tv, tr = tm.topk_tokens(queries, 10)
    assert_same_topk(tv, tr, jv, jr, rtol=1e-6, atol=CUMSUM_ATOL)


@pytest.mark.parametrize("cls,knobs", [
    ("BM25Model", dict(prf=True)),
    ("BM25Model", dict(prf=True, prf_docs=5, prf_terms=8, prf_beta=0.5,
                       prf_min_docs=1)),
    ("BM25Model", dict(prf=True, topk_mode="exact_compact")),
    ("TfidfCosineModel", dict(prf=True)),
    ("BM25Model", dict(spell_correct=True)),
    ("BM25Model", dict(prf=True, spell_correct=True, use_fused_topk=False)),
])
def test_model_knobs_match_jax(cls, knobs):
    docs = _docs(9, n_docs=240)
    jm, tm = _models(docs, cls)
    jm, tm = dataclasses.replace(jm, **knobs), dataclasses.replace(tm, **knobs)
    queries = _knob_queries(docs)
    for batch in (queries, queries[:1]):          # matmul and gather heads
        jv, jr = jm.topk_tokens(batch, 10)
        tv, tr = tm.topk_tokens(batch, 10)
        assert_same_topk(tv, tr, jv, jr, rtol=1e-6, atol=CUMSUM_ATOL)
    if knobs.get("prf"):
        off = dataclasses.replace(tm, prf=False)
        assert not np.array_equal(off.topk_tokens(queries, 10)[0],
                                  tm.topk_tokens(queries, 10)[0])


def test_spell_copy_repairs_like_jax():
    docs = _docs(2, n_docs=80)
    terms = sorted({t for d in docs for t in d}) + ["alpha", "alphabet", "beta"]
    df = np.arange(len(terms), dtype=np.float32)
    jr, tr = JRepairer(terms, df), TRepairer(terms, df)
    probes = ["alpah", "alpa", "bta", "t12", "t9x", "zzzz", "alphabe", "t"]
    assert [tr.repair(p) for p in probes] == [jr.repair(p) for p in probes]
    known = {t: i for i, t in enumerate(terms)}
    lists = [["alpah", "t1"], ["a_b", "bta"], []]
    assert tr.repair_token_lists(lists, known) == \
        jr.repair_token_lists(lists, known)
