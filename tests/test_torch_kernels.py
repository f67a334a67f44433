"""The port's top-k, kernel plain versions and scoring against the JAX
package, on CPU.

On the CPU each kernel wrapper takes its plain torch version (the CUDA
kernels are held against those plain versions on the card by
chip_smoke.py).  The JAX side runs its Pallas kernels in interpret mode.
Indexes are built by ``tdr`` and carried across with
``sparse_index_from_arrays``, so a difference here is a scoring fault, not
a build fault.
"""

import dataclasses

import numpy as np
import pytest

from tests.torch_threads import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tdr.ckpt.registry import _to_numpy_savable  # noqa: E402
from tdr.index import build_index  # noqa: E402
from tdr.ops import topk as jtopk  # noqa: E402
from tdr.ops.pallas_flat import fused_head_topk as j_fused_head_topk  # noqa: E402
from tdr.ops.pallas_tail import tail_compact_pallas  # noqa: E402
from tdr.ops.score import score_and_topk as j_score_and_topk  # noqa: E402
from tdr.ops.score import score_and_topk_fused as j_fused  # noqa: E402
from tdr.text import build_vocab, encode_docs, encode_queries  # noqa: E402
from tdr.utils.config import IndexConfig  # noqa: E402
from tdr_torch.index.build import sparse_index_from_arrays  # noqa: E402
from tdr_torch.ops import cuda_build, fused_head, tail_compact  # noqa: E402
from tdr_torch.ops import topk as ttopk  # noqa: E402
from tdr_torch.ops.score import score_and_topk as t_score_and_topk  # noqa: E402
from tdr_torch.ops.score import score_and_topk_fused as t_fused  # noqa: E402


def carry(j):
    """A JAX-built SparseIndex → the port's, through the checkpoint layout."""
    arrays, dtypes = {}, {}
    for name in ("indptr", "postings_doc", "postings_w", "postings_tf",
                 "head_slot", "head_rows"):
        arrays[name], dtypes[name] = _to_numpy_savable(getattr(j, name))
    if j.head_scale is not None:
        arrays["head_scale"], dtypes["head_scale"] = _to_numpy_savable(j.head_scale)
    for name in ("df", "idf", "doc_len", "avgdl"):
        arrays[f"stats_{name}"], dtypes[f"stats_{name}"] = \
            _to_numpy_savable(getattr(j.stats, name))
    meta = {"statics": {k: getattr(j, k) for k in (
        "n_docs", "n_docs_pad", "vocab_size", "tail_pmax", "head_size")},
        "dtypes": dtypes}
    return sparse_index_from_arrays(arrays, meta, device="cpu")


def assert_same_topk(tv, tr, jv, jr, rtol=1e-5, atol=1e-5):
    """Values within tolerance; a row may differ only where JAX's two
    scores are within that tolerance of each other (a near-tie that another
    summation order may break the other way)."""
    tv, tr, jv, jr = (np.asarray(x) for x in (tv, tr, jv, jr))
    assert tv.shape == jv.shape and tr.shape == jr.shape
    fin = np.isfinite(jv)
    np.testing.assert_array_equal(np.isfinite(tv), fin)
    np.testing.assert_allclose(tv[fin], jv[fin], rtol=rtol, atol=atol)
    for q, j in zip(*np.nonzero((tr != jr) & fin)):
        near = np.isclose(jv[q], jv[q, j], rtol=rtol, atol=atol)
        assert near.sum() >= 2, f"query {q} rank {j}: row differs"


def _world(seed, n_docs=400, vocab_n=900, n_queries=24, qlen=(1, 12),
           max_terms=32):
    rng = np.random.RandomState(seed)
    docs = [[f"t{rng.randint(vocab_n)}" for _ in range(rng.randint(5, 80))]
            for _ in range(n_docs)]
    vocab = build_vocab(docs)
    coo = encode_docs(docs, vocab)
    queries = [[f"t{rng.randint(vocab_n)}" for _ in range(rng.randint(*qlen))]
               for _ in range(n_queries)]
    qids, qw = encode_queries(queries, vocab, max_terms)
    return vocab, coo, qids, qw


# -- top-k tie order ----------------------------------------------------------

def _tie_rows(seed):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 4, size=(6, 300)).astype(np.float32)
    x[1] = 1.0                                     # one big tie
    x[2, ::3] = -np.inf                            # -inf padding
    x[3] = -np.inf                                 # an all -inf row
    x[4, 250:] = -np.inf
    return x


@pytest.mark.parametrize("k", [1, 10, 37])
def test_fast_topk_tie_order_matches_lax(k):
    x = _tie_rows(k)
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    tv, ti = ttopk.fast_topk(torch.from_numpy(x), k)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("group", [8, 32])
def test_topk_grouped_and_merge_match_jax(group):
    x = _tie_rows(group)
    x = np.concatenate([x, x[:, :212]], axis=1)      # 512 columns
    jv, ji = jtopk.topk_grouped(jnp.asarray(x), 10, group=group)
    tv, ti = ttopk.topk_grouped(torch.from_numpy(x), 10, group=group)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    rng = np.random.RandomState(group)
    vg = rng.randint(0, 3, size=(3, 6, 4)).astype(np.float32)
    rg = rng.randint(0, 100, size=(3, 6, 4)).astype(np.int32)
    for top_k in (5, 20):
        jv, jr = jtopk.merge_gathered_topk(jnp.asarray(vg), jnp.asarray(rg), top_k)
        tv, tr = ttopk.merge_gathered_topk(torch.from_numpy(vg),
                                           torch.from_numpy(rg), top_k)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


# -- K1: tail compaction ------------------------------------------------------

TAIL_CFG = IndexConfig(doc_pad_multiple=128, nnz_pad_multiple=64,
                       head_budget_bytes=1 << 16, head_dtype="float32")


def _overflow_queries(j, n=6, T=32, seed=1):
    """Queries of 1..30 tail terms: some over MT=16 terms, some over budget."""
    head_slot = np.asarray(j.head_slot)
    df = np.asarray(j.stats.df)
    tail_terms = np.where((head_slot < 0) & (df > 0))[0]
    rng = np.random.RandomState(seed)
    qids = np.zeros((n, T), np.int32)
    qw = np.zeros((n, T), np.float32)
    for i, m in enumerate([1, 2, 5, 16, 17, 30][:n]):
        m = min(m, len(tail_terms))
        qids[i, :m] = rng.choice(tail_terms, m, replace=False)
        qw[i, :m] = rng.choice([1.0, 2.0, 0.5], m)
    return qids, qw


@pytest.mark.parametrize("seed,budget_mult", [(0, 4), (7, 4), (3, 16)])
def test_tail_compact_plain_bit_exact_vs_pallas(seed, budget_mult):
    vocab, coo, qids, qw = _world(seed)
    j = build_index(*coo, vocab.size, index_cfg=TAIL_CFG, head_size=16)
    t = carry(j)
    oq, ow = _overflow_queries(j, T=qids.shape[1])
    qids = np.concatenate([qids, oq])
    qw = np.concatenate([qw, ow])
    budget = budget_mult * j.tail_pmax
    jd, jv, jo = tail_compact_pallas(j, jnp.asarray(qids), jnp.asarray(qw),
                                     budget, interpret=True)
    before = dict(cuda_build.launches)
    td, tv, to = tail_compact.tail_compact(t, torch.from_numpy(qids),
                                           torch.from_numpy(qw), budget)
    assert cuda_build.launches == before        # CPU tensors: plain version
    assert np.asarray(jo).any(), "the case must include overflowed rows"
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    # bit for bit, overflowed rows included
    np.testing.assert_array_equal(tv.numpy().view(np.int32),
                                  np.asarray(jv).view(np.int32))


# -- K2: fused full-vocab head ------------------------------------------------

_BIG = {}


def _big_index(head_dtype):
    """A full-vocab head over >= 65,536 padded docs with a small vocab: the
    shape gate of the fused engine passes."""
    if head_dtype not in _BIG:
        rng = np.random.RandomState(5)
        n_docs, vocab_n = 50_000, 120
        lens = rng.randint(1, 6, size=n_docs)
        doc_ids = np.repeat(np.arange(n_docs, dtype=np.int32), lens)
        term_ids = np.concatenate([rng.choice(vocab_n, l, replace=False)
                                   for l in lens]).astype(np.int32)
        tfs = rng.randint(1, 4, size=doc_ids.shape[0]).astype(np.float32)
        doc_lens = np.bincount(doc_ids, weights=tfs,
                               minlength=n_docs).astype(np.int32)
        df = np.bincount(term_ids, minlength=vocab_n).astype(np.int32)
        j = build_index(doc_ids, term_ids, tfs, doc_lens, vocab_n,
                        index_cfg=IndexConfig(head_budget_bytes=1 << 30,
                                              head_dtype=head_dtype),
                        df_host=df)
        assert j.head_size >= j.vocab_size and j.n_docs_pad >= 65536
        _BIG[head_dtype] = (j, carry(j))
    return _BIG[head_dtype]


def _big_queries(seed=3, n=20, T=16):
    rng = np.random.RandomState(seed)
    qids = rng.randint(0, 120, size=(n, T)).astype(np.int32)
    qw = (rng.rand(n, T) < 0.4).astype(np.float32)
    qids[1, :6] = [4, 9, 4, 9, 4, 9]              # duplicate-slot guard
    qw[1, :6] = 1.0
    qids[2, :4] = [7, 7, 7, 7]
    qw[2, :4] = [1.0, 2.0, 0.0, 1.0]
    qw[3] = 0.0                                   # an empty query
    return qids, qw


@pytest.mark.parametrize("head_dtype", ["float32", "bfloat16"])
def test_fused_head_plain_matches_pallas(head_dtype):
    j, t = _big_index(head_dtype)
    qids, qw = _big_queries()
    assert fused_head.fused_head_available(t, 10)
    jv, jr = j_fused_head_topk(j, jnp.asarray(qids), jnp.asarray(qw),
                               top_k=10, interpret=True)
    tv, tr = fused_head.fused_head_topk(t, torch.from_numpy(qids),
                                        torch.from_numpy(qw), top_k=10)
    # the rescore sums at most 16 f32 products in another order
    assert_same_topk(tv, tr, jv, jr, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("top_k,q_chunk", [(10, 3), (266, 7), (1034, 1)])
def test_fused_head_chunked_rescore_matches_pallas(top_k, q_chunk, monkeypatch):
    """The rescore in query chunks (ragged last chunk at 3 and 7 of 20
    queries, one query a step at the widest top_k) equals the whole-batch
    rescore exactly and tdr's within the 16-product rounding."""
    j, t = _big_index("float32")
    qids, qw = _big_queries()
    q, w = torch.from_numpy(qids), torch.from_numpy(qw)
    whole_v, whole_r = fused_head.fused_head_topk(t, q, w, top_k=top_k)
    T, C = qids.shape[1], 8 * top_k
    monkeypatch.setattr(fused_head, "_RESCORE_ELEMS", q_chunk * T * C)
    tv, tr = fused_head.fused_head_topk(t, q, w, top_k=top_k)
    np.testing.assert_array_equal(tv.numpy(), whole_v.numpy())
    np.testing.assert_array_equal(tr.numpy(), whole_r.numpy())
    jv, jr = j_fused_head_topk(j, jnp.asarray(qids), jnp.asarray(qw),
                               top_k=top_k, interpret=True)
    assert_same_topk(tv, tr, jv, jr, rtol=1e-6, atol=1e-6)


def _compact_case(case, D=200, Q=24, T=12, seed=4):
    """(slot (Q, T), active (Q, T), qw (Q, T)) for one compaction case."""
    rng = np.random.RandomState(seed)
    slot = rng.randint(0, D, size=(Q, T))
    qw = rng.rand(Q, T).astype(np.float32) + 0.1
    active = rng.rand(Q, T) < 0.7
    if case == "mixed":
        slot[1, :6] = [4, 9, 4, 9, 4, 9]              # duplicate slots
        active[1, :6] = True
        active[3] = False                             # an empty query
        slot[rng.rand(Q, T) < 0.1] = -1               # tail terms
    elif case == "none":
        active[:] = False
    elif case == "all":                               # every slot used
        slot = (np.arange(Q * T) % D).reshape(Q, T)
        active[:] = True
    elif case == "ragged":             # 100 slots: not a multiple of 64
        slot = np.concatenate([np.arange(100),
                               rng.randint(0, 100, Q * T - 100)]).reshape(Q, T)
        active[:] = True
    active &= slot >= 0
    return slot, active, qw


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["mixed", "none", "all", "ragged"])
def test_compact_active_rows(case, dtype):
    D, Q = 200, 24
    slot, active, qw = _compact_case(case, D, Q)
    W = np.zeros((Q, D), np.float32)
    for q, t in zip(*np.nonzero(active)):
        W[q, slot[q, t]] += qw[q, t]
    dt = getattr(torch, dtype)
    rows, n_active, Wc = fused_head.compact_active_rows(
        torch.from_numpy(W), torch.from_numpy(slot), torch.from_numpy(active),
        128, dt)
    used = np.unique(slot[active])
    n = int(n_active)
    expect_n = {"none": 0, "all": D, "ragged": 100}.get(case, len(used))
    assert n == len(used) == expect_n
    assert rows.dtype == torch.int32 and n_active.dtype == torch.int32
    assert n_active.shape == (1,) and Wc.shape == (128, D) and Wc.dtype == dt
    r = rows.numpy()
    np.testing.assert_array_equal(np.sort(r), np.arange(D))  # a permutation
    np.testing.assert_array_equal(r[:n], used)        # used slots, ascending
    np.testing.assert_array_equal(r[n:], np.setdiff1d(np.arange(D), used))
    ref = torch.from_numpy(W[:, r]).to(dt)
    np.testing.assert_array_equal(Wc[:Q].float().numpy(), ref.float().numpy())
    assert not Wc[:, n:].any() and not Wc[Q:].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["mixed", "none", "all", "ragged"])
def test_compacted_plain_matches_full_head(case, dtype):
    D, Q, N = 200, 24, 1024
    slot, active, qw = _compact_case(case, D, Q, seed=9)
    rng = np.random.RandomState(2)
    head = (rng.rand(D, N) * (rng.rand(D, N) < 0.1)).astype(np.float32)
    bias = np.where(np.arange(N) < N - 40, 0.0, fused_head.NEG).astype(np.float32)
    W = np.zeros((Q, D), np.float32)
    for q, t in zip(*np.nonzero(active)):
        W[q, slot[q, t]] += qw[q, t]
    dt = getattr(torch, dtype)
    th = torch.from_numpy(head).to(dt)
    rows, n_active, Wc = fused_head.compact_active_rows(
        torch.from_numpy(W), torch.from_numpy(slot), torch.from_numpy(active),
        128, dt)
    tb = torch.from_numpy(bias)
    before = dict(cuda_build.launches)
    got = fused_head.fused_head_blockmax(Wc, th, rows, n_active, tb)
    assert cuda_build.launches == before        # CPU tensors: plain version
    Wp = torch.zeros((128, D), dtype=dt)
    Wp[:Q] = torch.from_numpy(W).to(dt)
    full = (Wp.float() @ th.float() + tb).view(128, -1, 8).amax(-1)
    # the same products of the same rounded operands: only the f32
    # summation order differs (zero columns skipped, rows gathered)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=1e-5, atol=1e-6)


def test_fused_head_gate_matches_jax():
    from tdr.ops.pallas_flat import fused_head_available as j_gate

    j, t = _big_index("float32")
    assert j_gate(j, 10) and fused_head.fused_head_available(t, 10)
    small = dataclasses.replace(t, head_rows=t.head_rows[:, :4096])
    assert not fused_head.fused_head_available(small, 10)
    int8 = dataclasses.replace(t, head_rows=t.head_rows.to(torch.int8))
    assert not fused_head.fused_head_available(int8, 10)


# -- score_and_topk_fused -----------------------------------------------------

@pytest.mark.parametrize("case", ["tail_matmul", "tail_gather", "overflow",
                                  "full_head", "bf16_tail"])
def test_score_and_topk_fused_matches_jax(case):
    vocab, coo, qids, qw = _world(11, n_queries=20)
    cfg = TAIL_CFG
    if case == "bf16_tail":
        cfg = dataclasses.replace(TAIL_CFG, head_dtype="bfloat16")
    head_size = {"full_head": None, "tail_gather": 24}.get(case, 16)
    if case == "full_head":
        cfg = dataclasses.replace(TAIL_CFG, head_budget_bytes=1 << 30)
    j = build_index(*coo, vocab.size, index_cfg=cfg, head_size=head_size)
    t = carry(j)
    engine = "matmul"
    if case == "tail_gather":
        engine = "gather"
        qids, qw = qids[:8], qw[:8]
        # more than 16 active head terms: the gather engine overflows
        heads = np.where(np.asarray(j.head_slot) >= 0)[0][:20]
        qids[0, :20] = heads
        qw[0, :20] = 1.0
    if case == "overflow":
        oq, ow = _overflow_queries(j, T=qids.shape[1])
        qids, qw = np.concatenate([qids, oq]), np.concatenate([qw, ow])
    kw = dict(top_k=10, tail_budget=64)
    jv, jr = j_fused(j, jnp.asarray(qids), jnp.asarray(qw),
                     head_engine=engine, **kw)
    tv, tr = t_fused(t, torch.from_numpy(qids), torch.from_numpy(qw),
                     head_engine=engine, **kw)
    assert_same_topk(tv, tr, jv, jr)
    sv, sr = j_score_and_topk(j, jnp.asarray(qids), jnp.asarray(qw), top_k=10)
    uv, ur = t_score_and_topk(t, torch.from_numpy(qids), torch.from_numpy(qw),
                              top_k=10)
    assert_same_topk(uv, ur, sv, sr)


def test_score_and_topk_fused_fused_engine_matches_jax():
    j, t = _big_index("float32")
    qids, qw = _big_queries(seed=8, n=12)
    jv, jr = j_fused(j, jnp.asarray(qids), jnp.asarray(qw), top_k=10,
                     head_engine="fused_interpret")
    tv, tr = t_fused(t, torch.from_numpy(qids), torch.from_numpy(qw),
                     top_k=10, head_engine="fused")
    assert_same_topk(tv, tr, jv, jr)


@pytest.mark.parametrize("case", ["approx", "exact_compact", "_tail_compact",
                                  "score_candidates_fused", "score_pairs"])
def test_unported_modes_raise(case):
    """Once "not ported yet": each of these now runs and matches tdr
    (tail sums through a cumsum difference within 1e-4 absolute, see
    test_torch_score_modes.py; the rest within rtol 1e-6 or bit for bit)."""
    from tdr.ops import score as jscore
    from tdr_torch.ops import score

    vocab, coo, qids, qw = _world(2, n_queries=4)
    j = build_index(*coo, vocab.size, index_cfg=TAIL_CFG, head_size=16)
    t = carry(j)
    q, w = torch.from_numpy(qids), torch.from_numpy(qw)
    jq, jw = jnp.asarray(qids), jnp.asarray(qw)
    cand = np.random.RandomState(1).randint(0, t.n_docs, (4, 20)).astype(np.int32)
    if case in ("approx", "exact_compact"):
        jv, jr = j_fused(j, jq, jw, topk_mode=case,
                         tail_engine="pallas_interpret")
        tv, tr = t_fused(t, q, w, topk_mode=case)
        assert_same_topk(tv, tr, jv, jr, rtol=1e-6, atol=1e-4)
    elif case == "_tail_compact":
        got = score._tail_compact(t, q, w, 64)
        want = jscore._tail_compact(j, jq, jw, 64)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    else:
        got = getattr(score, case)(t, q, w, torch.from_numpy(cand))
        want = getattr(jscore, case)(j, jq, jw, jnp.asarray(cand))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
