"""The port's exact_compact / approx top-k modes, the sort compactor,
candidate re-scoring and the small scoring helpers against the JAX
package, on CPU.

Indexes are built by ``tdr`` and carried across (``carry``), so a
difference is a scoring fault.  The JAX side compacts its tails with the
Pallas kernel in interpret mode, whose row width is the port kernel's, so
both run the same tier-1 cut.  ``TDR_AB_KSEL`` / ``TDR_AB_M`` stay unset.

A tail sum is the difference of two prefix sums over up to 2,048 slots.
On the CPU the port takes them in XLA's order (``ops/scan.py``); on the
card one ``torch.cumsum`` rounds otherwise by the prefix sum's ulps.
Values through them compare at rtol 1e-6 plus ``CUMSUM_ATOL``, a bound
that the card's order meets too; everything else at rtol 1e-6.
"""

import numpy as np
import pytest

from tests.torch_threads import torch

import jax.numpy as jnp  # noqa: E402

from tdr.index import build_index  # noqa: E402
from tdr.ops import score as jscore  # noqa: E402
from tdr_torch.ops import score as tscore  # noqa: E402
from tdr_torch.ops import tail_compact as ttail  # noqa: E402
from test_torch_kernels import (TAIL_CFG, _overflow_queries, _world,  # noqa: E402
                                assert_same_topk, carry)

_CASES = {}
CUMSUM_ATOL = 1e-4


def _case(name):
    """(jax index, port index, qids, qw) for one world."""
    if name not in _CASES:
        if name == "tail":
            vocab, coo, qids, qw = _world(11, n_docs=500, n_queries=24)
            j = build_index(*coo, vocab.size, index_cfg=TAIL_CFG, head_size=16)
        else:   # "heavy": the densest terms repeated, many live tail slots
            vocab, coo, qids, qw = _world(12, n_docs=700, n_queries=24)
            j = build_index(*coo, vocab.size, index_cfg=TAIL_CFG, head_size=8)
            df = np.asarray(j.stats.df)
            tail = np.where(np.asarray(j.head_slot) < 0)[0]
            dense = tail[np.argsort(-df[tail])][:40]
            rng = np.random.RandomState(3)
            qids = qids.copy()
            qids[:, :12] = dense[rng.randint(0, 40, (qids.shape[0], 12))]
            qw = np.maximum(qw, 1.0)
            oq, ow = _overflow_queries(j, n=6, T=qids.shape[1])
            qids, qw = np.concatenate([qids, oq]), np.concatenate([qw, ow])
        _CASES[name] = (j, carry(j), qids, qw)
    return _CASES[name]


def _both(fn_j, fn_t, qids, qw):
    return (fn_j(jnp.asarray(qids), jnp.asarray(qw)),
            fn_t(torch.from_numpy(qids), torch.from_numpy(qw)))


@pytest.mark.parametrize("mode", ["exact_compact", "approx"])
@pytest.mark.parametrize("world", ["tail", "heavy"])
def test_topk_modes_match_jax(mode, world):
    j, t, qids, qw = _case(world)
    kw = dict(top_k=10, tail_budget=64)
    (jv, jr), (tv, tr) = _both(
        lambda q, w: jscore.score_and_topk_fused(
            j, q, w, topk_mode=mode, tail_engine="pallas_interpret", **kw),
        lambda q, w: tscore.score_and_topk_fused(t, q, w, topk_mode=mode, **kw),
        qids, qw)
    assert_same_topk(tv, tr, jv, jr, rtol=1e-6, atol=CUMSUM_ATOL)
    # and the port's own exact mode: the same tail sums
    ev, er = tscore.score_and_topk_fused(t, torch.from_numpy(qids),
                                         torch.from_numpy(qw), **kw)
    assert_same_topk(tv, tr, ev, er, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("top_k,tail_budget", [(260, 768), (300, 768),
                                                (300, 2048)])
def test_tier2_trip_is_exact(top_k, tail_budget):
    """The heavy world's dense tail gives each query hundreds of live tail
    slots: at a top_k past M = 256 the tier-1 bound trips and the
    full-width tier 2 re-merges; the result stays exact."""
    j, t, qids, qw = _case("heavy")
    q, w = torch.from_numpy(qids), torch.from_numpy(qw)
    kw = dict(top_k=top_k, tail_budget=tail_budget)
    tscore.reset_tier2_stats()
    cv, cr = tscore.score_and_topk_fused(t, q, w, topk_mode="exact_compact",
                                         **kw)
    assert tscore.tier2_stats["exact_compact"] == {"batches": 1, "trips": 1}
    ev, er = tscore.score_and_topk_fused(t, q, w, **kw)
    assert_same_topk(cv, cr, ev, er, rtol=1e-6, atol=1e-6)
    jv, jr = jscore.score_and_topk_fused(j, jnp.asarray(qids), jnp.asarray(qw),
                                         **kw)
    assert_same_topk(cv, cr, jv, jr, rtol=1e-6, atol=CUMSUM_ATOL)


@pytest.mark.parametrize("budget", [16, 64, 4096])
def test_sort_compactor_matches_jax_and_kernel(budget):
    """``_tail_compact`` bit for bit against tdr's; per query the same
    multiset of live (doc, value) slots as the kernel's plain version."""
    j, t, qids, qw = _case("heavy")
    (jd, jv, ja, jo), (td, tv, ta, to) = _both(
        lambda q, w: jscore._tail_compact(j, q, w, budget),
        lambda q, w: tscore._tail_compact(t, q, w, budget), qids, qw)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tv.numpy().view(np.int32),
                                  np.asarray(jv).view(np.int32))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    kd, kv, ko = ttail.tail_compact(t, torch.from_numpy(qids),
                                    torch.from_numpy(qw), budget)
    np.testing.assert_array_equal(ko.numpy(), to.numpy())
    for q in np.nonzero(~to.numpy())[0]:
        a = sorted(zip(td[q][ta[q]].tolist(), tv[q][ta[q]].tolist()))
        live = kv[q] >= 0
        b = sorted(zip(kd[q][live].tolist(), kv[q][live].tolist()))
        assert a == b, f"query {q}"


def _cands(t, n, seed=0, C=33):
    rng = np.random.RandomState(seed)
    return rng.randint(0, t.n_docs, (n, C)).astype(np.int32)


@pytest.mark.parametrize("budget", [8, 64])
def test_score_candidates_fused_matches_jax(budget):
    """tdr's own output within rtol 1e-6 (K1's plain version against the
    interpreted Pallas kernel), the overflowed rows through score_pairs;
    on this f32 head the binary-search scores within rtol 1e-6 too."""
    j, t, qids, qw = _case("heavy")
    cand = _cands(t, qids.shape[0])
    (jf, tf) = _both(
        lambda q, w: jscore.score_candidates_fused(
            j, q, w, jnp.asarray(cand), tail_budget=budget,
            tail_engine="pallas_interpret"),
        lambda q, w: tscore.score_candidates_fused(
            t, q, w, torch.from_numpy(cand), tail_budget=budget), qids, qw)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6, atol=1e-6)
    sp = tscore.score_pairs(t, torch.from_numpy(qids), torch.from_numpy(qw),
                            torch.from_numpy(cand))
    np.testing.assert_allclose(tf.numpy(), sp.numpy(), rtol=1e-6, atol=1e-6)


def test_score_candidates_fused_bf16_bound():
    """On a bf16 head the fused scores differ from the f32-exact binary
    search by at most the head's rounding: 2^-8 of each head term's
    weight, summed over the query's head terms (tdr's docstring)."""
    vocab, coo, qids, qw = _world(13, n_docs=400, n_queries=16)
    import dataclasses

    j = build_index(*coo, vocab.size, head_size=24,
                    index_cfg=dataclasses.replace(TAIL_CFG,
                                                  head_dtype="bfloat16"))
    t = carry(j)
    cand = _cands(t, qids.shape[0], seed=2)
    q, w, c = (torch.from_numpy(x) for x in (qids, qw, cand))
    jf = np.asarray(jscore.score_candidates_fused(
        j, jnp.asarray(qids), jnp.asarray(qw), jnp.asarray(cand),
        tail_engine="pallas_interpret"))
    tf = tscore.score_candidates_fused(t, q, w, c).numpy()
    np.testing.assert_allclose(tf, jf, rtol=1e-6, atol=1e-6)
    sp = tscore.score_pairs(t, q, w, c).numpy()
    head_part = tscore.score_pairs(
        t, q, torch.where(t.head_slot[q.long()] >= 0, w, torch.zeros_like(w)),
        c).numpy()
    assert np.all(np.abs(tf - sp) <= 2.0 ** -8 * head_part + 1e-6)
    assert np.abs(tf - sp).max() > 0          # the bound is not vacuous


def test_score_pairs_matches_jax():
    j, t, qids, qw = _case("tail")
    cand = _cands(t, qids.shape[0], seed=5, C=40)
    cand[:, 0] = 0                                 # the first and last rows
    cand[:, 1] = t.n_docs - 1
    jp = np.asarray(jscore.score_pairs(j, jnp.asarray(qids), jnp.asarray(qw),
                                       jnp.asarray(cand)))
    tp = tscore.score_pairs(t, torch.from_numpy(qids), torch.from_numpy(qw),
                            torch.from_numpy(cand)).numpy()
    np.testing.assert_allclose(tp, jp, rtol=1e-6, atol=1e-7)
    assert (tp > 0).any()


def test_score_batch_and_small_topk_helpers_match_jax():
    j, t, qids, qw = _case("tail")
    js = np.asarray(jscore.score_batch(j, jnp.asarray(qids), jnp.asarray(qw)))
    ts = tscore.score_batch(t, torch.from_numpy(qids),
                            torch.from_numpy(qw)).numpy()
    np.testing.assert_allclose(ts, js, rtol=1e-6, atol=1e-6)
    rng = np.random.RandomState(0)
    x = rng.randint(0, 30, (5, 8192)).astype(np.float32)   # many ties
    for k in (1, 10):
        for jf, tf in ((jscore.topk_masked, tscore.topk_masked),
                       (jscore._topk_2stage, tscore._topk_2stage)):
            jv, ji = jf(jnp.asarray(x), k)
            tv, ti = tf(torch.from_numpy(x), k)
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
            np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    doc_langs = rng.randint(0, 3, 8192).astype(np.int32)
    q_langs = np.array([0, 1, 2, jscore.WILDCARD_LANG, 5], np.int32)
    jv, ji = jscore.topk_language_filtered(jnp.asarray(x), jnp.asarray(doc_langs),
                                           jnp.asarray(q_langs), top_k=10)
    tv, ti = tscore.topk_language_filtered(
        torch.from_numpy(x), torch.from_numpy(doc_langs),
        torch.from_numpy(q_langs), top_k=10)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert tscore.WILDCARD_LANG == jscore.WILDCARD_LANG
