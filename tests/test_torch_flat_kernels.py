"""K3 (fused flat top-k) and K4 (head-row score accumulation) in the port
against the JAX package, on CPU.

On the CPU each kernel wrapper takes its plain torch version (chip_smoke.py
holds the CUDA kernels against those plain versions on the card).  The JAX
side runs its Pallas kernels in interpret mode.  Indexes are built by
``tdr`` and carried across, so a difference here is a search fault, not a
build fault.
"""

import dataclasses

import numpy as np
import pytest

from tests.torch_threads import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tdr.ckpt.registry import _to_numpy_savable  # noqa: E402
from tdr.index import build_index  # noqa: E402
from tdr.models import dense as jdense  # noqa: E402
from tdr.ops.pallas_flat import fused_flat_available as j_gate  # noqa: E402
from tdr.ops.pallas_flat import fused_flat_topk as j_fused_flat  # noqa: E402
from tdr.ops.pallas_score import head_scores_pallas  # noqa: E402
from tdr.ops.score import _head_scores  # noqa: E402
from tdr.text import build_vocab, encode_docs, encode_queries  # noqa: E402
from tdr.utils.config import IndexConfig  # noqa: E402
from tdr_torch.index.build import sparse_index_from_arrays  # noqa: E402
from tdr_torch.models import dense as tdense  # noqa: E402
from tdr_torch.ops import cuda_build, fused_flat, head_scores  # noqa: E402
from tdr_torch.ops.score import _head_scores_capped  # noqa: E402

N, D = 8192, 128        # the smallest fused-eligible shape


def assert_same_topk(tv, tr, jv, jr, rtol=1e-5, atol=1e-5):
    """Values within tolerance; a row may differ only where JAX's two
    scores are within that tolerance of each other (a near-tie that another
    summation order may break the other way)."""
    tv, tr, jv, jr = (np.asarray(x) for x in (tv, tr, jv, jr))
    assert tv.shape == jv.shape and tr.shape == jr.shape
    fin = np.isfinite(jv)
    np.testing.assert_array_equal(np.isfinite(tv), fin)
    np.testing.assert_allclose(tv[fin], jv[fin], rtol=rtol, atol=atol)
    np.testing.assert_array_equal(tr[~fin], jr[~fin])
    for q, j in zip(*np.nonzero((tr != jr) & fin)):
        near = np.isclose(jv[q], jv[q, j], rtol=rtol, atol=atol)
        assert near.sum() >= 2, f"query {q} rank {j}: row differs"


# -- K3: fused flat top-k -----------------------------------------------------

def _world(seed=0, n=N - 37, q=29):
    rng = np.random.RandomState(seed)
    emb = rng.randn(n, D).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    return emb, rng.randn(q, D).astype(np.float32)


def _jax_index(emb, metric, dtype):
    """tdr's build; its builder has no f32 storage, so f32 is assembled the
    way it stores the other two (padded rows, +inf ‖d‖² on padding)."""
    if dtype != "float32":
        return jdense.build_flat_index(emb, metric=metric, dtype=dtype)
    b = jdense.build_flat_index(emb, metric=metric)
    e = np.zeros((b.embeddings.shape[0], emb.shape[1]), np.float32)
    e[:emb.shape[0]] = emb
    return jdense.FlatIndex(embeddings=jnp.asarray(e), doc_sq=b.doc_sq,
                            n_docs=b.n_docs, metric=metric)


def carry_flat(j):
    """A JAX-built FlatIndex → the port's, in the dense checkpoint layout."""
    arrays = {}
    arrays["embeddings"], emb_dtype = _to_numpy_savable(j.embeddings)
    for name in ("doc_scale", "doc_sq"):
        if getattr(j, name) is not None:
            arrays[name] = np.asarray(getattr(j, name))
    meta = {"emb_dtype": emb_dtype, "n_docs": j.n_docs, "metric": j.metric}
    return tdense.flat_index_from_arrays(arrays, meta, device="cpu")


def _fused_args(j):
    return dict(metric=j.metric, n_docs=j.n_docs, doc_sq=j.doc_sq,
                doc_scale=j.doc_scale)


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "float32"])
def test_flat_search_matches_pallas_and_xla(dtype, metric):
    emb, queries = _world(seed={"bfloat16": 0, "int8": 1, "float32": 2}[dtype])
    j = _jax_index(emb, metric, dtype)
    t = carry_flat(j)
    assert t.embeddings.dtype == {"bfloat16": torch.bfloat16,
                                  "int8": torch.int8,
                                  "float32": torch.float32}[dtype]
    jq, tq = jnp.asarray(queries), torch.from_numpy(queries)
    jv, jr = j_fused_flat(j.embeddings, jq, top_k=10, interpret=True,
                          **_fused_args(j))
    xv, xr = jdense.flat_search(j, jq, 10, engine="xla")
    before = dict(cuda_build.launches)
    fv, fr = tdense.flat_search(t, tq, 10, engine="fused")
    pv, pr = tdense.flat_search(t, tq, 10, engine="plain")
    av, ar = tdense.flat_search(t, tq, 10)          # auto: plain on the CPU
    assert cuda_build.launches == before            # CPU tensors: no kernel
    assert torch.equal(av, pv) and torch.equal(ar, pr)
    # the same algorithm on both sides: rows equal, the f32 rescore sums
    # 128 products in another order
    assert_same_topk(fv, fr, jv, jr, rtol=1e-6, atol=1e-6)
    assert_same_topk(pv, pr, xv, xr, rtol=1e-6, atol=1e-6)
    # across engines: int8 rescore against q8·qs rounds the scales at
    # another point than the product path
    assert_same_topk(pv, pr, jv, jr, rtol=1e-5, atol=1e-5)
    assert np.all(np.diff(fv.numpy(), axis=1) <= 0)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "float32"])
def test_blockmax_plain_matches_rescore(dtype):
    """The kernel's plain version gives each group the maximum of the same
    scores phase 2 rescores: every returned score is at most its group's
    maximum, and equals it for the best document."""
    emb, queries = _world(seed=4)
    t = carry_flat(_jax_index(emb, "ip", dtype))
    Qp = 128
    qpad = torch.zeros((Qp, D))
    qpad[:queries.shape[0]] = torch.from_numpy(queries)
    bias = torch.where(torch.arange(t.embeddings.shape[0]) < t.n_docs,
                       0.0, fused_flat.NEG).float()
    if dtype == "int8":
        q8, qs = fused_flat.quantize_queries_int8(qpad)
        g = fused_flat.fused_flat_blockmax(q8, t.embeddings, bias, 1.0,
                                           t.doc_scale, qs[:, 0])
        ref = ((q8.double() @ t.embeddings.double().T).float()
               * t.doc_scale[None, :] * qs)
    else:
        qk = qpad.to(t.embeddings.dtype)
        g = fused_flat.fused_flat_blockmax(qk, t.embeddings, bias, 1.0)
        ref = qk.double() @ t.embeddings.double().T
    ref = (ref.float() + bias).view(Qp, -1, 8).amax(-1)
    assert g.shape == (Qp, t.embeddings.shape[0] // 8) and g.dtype == torch.float32
    np.testing.assert_allclose(g.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_ragged_tiles_match_pallas(dtype):
    """Shapes off the CUDA kernel's 128-query x 256-document tile, through
    the plain version here: 200 queries (two query tiles, the second
    partial) and a document count that is a multiple of 64 but not of 256.
    chip_smoke.py holds the kernel's own ragged last tile against the plain
    version on the card."""
    emb, queries = _world(seed=6, n=N + 64 - 5, q=200)
    j = jdense.build_flat_index(emb, metric="ip", dtype=dtype)
    t = carry_flat(j)
    assert t.embeddings.shape[0] % 64 == 0 and t.embeddings.shape[0] % 256
    jv, jr = j_fused_flat(j.embeddings, jnp.asarray(queries), top_k=10,
                          interpret=True, **_fused_args(j))
    tv, tr = fused_flat.fused_flat_topk(t.embeddings, torch.from_numpy(queries),
                                        top_k=10, **_fused_args(t))
    assert np.all(tr.numpy() < t.n_docs)
    # the same algorithm on both sides; the f32 rescore sums 128 products
    # in another order
    assert_same_topk(tv, tr, jv, jr, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("layout", ["resident", "streamed"])
def test_flat_variants_cut_what_they_name(layout):
    """tdr_torch/tools/flat_variants.py builds K3 with parts taken out by
    editing its source: every anchor must stand once in fused_flat.cu, and
    each variant must lose exactly the part it names."""
    import os

    from tdr_torch.tools import flat_variants

    with open(os.path.join(cuda_build.SRC_DIR, "fused_flat.cu")) as f:
        src = f.read()
    v = flat_variants.variant_sources(src)
    full = v[(layout, "full")]
    assert ("const bool resident = false;" in full) == (layout == "streamed")
    assert "store_group_max(score" in full and "wgmma_m64n256k32_s8(acc" in full
    assert "store_group_max(score" not in v[(layout, "no_epilogue")]
    assert "wgmma_m64n256k16_bf16<0>(acc" not in v[(layout, "no_mma")]
    cut = v[(layout, "loads_only")]
    assert "store_group_max(score" not in cut and "wgmma_m64n256k32_s8(acc" not in cut
    assert "tma_load_2d(ring.b" in cut


def test_n_valid_override_matches_pallas():
    emb, queries = _world(seed=5, n=N)
    j = jdense.build_flat_index(emb, metric="ip")
    t = carry_flat(j)
    q = queries[:5]
    jv, jr = j_fused_flat(j.embeddings, jnp.asarray(q), top_k=10, metric="ip",
                          n_docs=N, n_valid=jnp.int32(100), interpret=True)
    tv, tr = fused_flat.fused_flat_topk(t.embeddings, torch.from_numpy(q),
                                        top_k=10, metric="ip", n_docs=N,
                                        n_valid=100)
    assert np.all(tr.numpy() < 100)
    assert_same_topk(tv, tr, jv, jr, rtol=1e-6, atol=1e-6)
    v2, r2 = fused_flat.fused_flat_topk(t.embeddings, torch.from_numpy(q),
                                        top_k=10, metric="ip", n_docs=100)
    assert torch.equal(tr, r2) and torch.equal(tv, v2)


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_few_valid_docs_pad_like_pallas(metric):
    """n_docs far below the padded length: padding never surfaces and short
    rows pad with (-inf, 0)."""
    rng = np.random.RandomState(1)
    emb = np.vstack([rng.randn(6, D), np.zeros((N - 6, D))]).astype(np.float32)
    j = jdense.build_flat_index(emb, metric=metric)
    j = dataclasses.replace(j, n_docs=6)
    t = carry_flat(j)
    q = rng.randn(4, D).astype(np.float32)
    jv, jr = j_fused_flat(j.embeddings, jnp.asarray(q), top_k=10,
                          interpret=True, **_fused_args(j))
    tv, tr = tdense.flat_search(t, torch.from_numpy(q), 10, engine="fused")
    pv, pr = tdense.flat_search(t, torch.from_numpy(q), 10, engine="plain")
    assert np.all(np.isfinite(tv[:, :6].numpy()))
    assert np.all(tv[:, 6:].numpy() == -np.inf) and np.all(tr.numpy() < 6)
    assert_same_topk(tv, tr, jv, jr, rtol=1e-6, atol=1e-6)
    # the product path keeps top-k's rows for -inf slots, as tdr's XLA path
    xv, xr = jdense.flat_search(j, jnp.asarray(q), 10, engine="xla")
    assert_same_topk(pv, pr, xv, xr, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ties_break_by_row_like_pallas(dtype):
    """Duplicate documents score equal: the order is row ascending, as
    lax.top_k's, on both engines."""
    rng = np.random.RandomState(6)
    base = rng.randn(40, D).astype(np.float32)
    emb = base[rng.randint(0, 40, size=N)]
    q = rng.randn(7, D).astype(np.float32)
    j = _jax_index(emb, "ip", dtype)
    t = carry_flat(j)
    jv, jr = j_fused_flat(j.embeddings, jnp.asarray(q), top_k=10,
                          interpret=True, **_fused_args(j))
    for engine in ("fused", "plain"):
        tv, tr = tdense.flat_search(t, torch.from_numpy(q), 10, engine=engine)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)


@pytest.mark.parametrize("shape,dtype", [
    ((8192, 128), "bfloat16"), ((4096, 128), "bfloat16"),
    ((8192, 100), "bfloat16"), ((8192, 128), "int8"),
    ((8192, 128), "float32"), ((8256, 256), "bfloat16"),
    ((268032, 384), "bfloat16"), ((8192, 128), "int32")])
def test_gate_matches_jax(shape, dtype):
    jt = {"bfloat16": jnp.bfloat16, "int8": jnp.int8, "float32": jnp.float32,
          "int32": jnp.int32}[dtype]
    tt = {"bfloat16": torch.bfloat16, "int8": torch.int8,
          "float32": torch.float32, "int32": torch.int32}[dtype]
    jz = jax.ShapeDtypeStruct(shape, jt)
    assert fused_flat.fused_flat_available(
        torch.empty(shape, dtype=tt, device="meta")) \
        == j_gate(jz)


def test_engine_choice():
    emb, queries = _world(seed=9, n=300)
    t = carry_flat(jdense.build_flat_index(emb))
    q = torch.from_numpy(queries[:3])
    v, r = tdense.flat_search(t, q, 10)             # gate fails: plain path
    assert v.shape == (3, 10) and r.dtype == torch.int64
    with pytest.raises(ValueError, match="unavailable"):
        tdense.flat_search(t, q, 10, engine="fused")
    with pytest.raises(ValueError, match="unknown"):
        tdense.flat_search(t, q, 10, engine="xla")
    av, ar = tdense.flat_search(t, q, 10, approx=True)
    assert torch.equal(av, v) and torch.equal(ar, r)


def test_quantize_queries_matches_jax():
    rng = np.random.RandomState(3)
    q = rng.randn(9, 64).astype(np.float32)
    q[2] = 0.0                                       # an all-zero row
    q[3, :4] = [127.0, 0.5, -0.5, 1.5]               # halves: round to even
    j8, js = jdense.quantize_queries_int8(jnp.asarray(q))
    t8, ts = tdense.quantize_queries_int8(torch.from_numpy(q))
    np.testing.assert_array_equal(t8.numpy(), np.asarray(j8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# -- K4: head-row score accumulation ------------------------------------------

def carry_sparse(j):
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


def _sparse_world(seed=0, n_docs=300, vocab_n=500, n_queries=16, T=32):
    rng = np.random.RandomState(seed)
    docs = [[f"t{rng.randint(vocab_n)}" for _ in range(rng.randint(5, 100))]
            for _ in range(n_docs)]
    vocab = build_vocab(docs)
    coo = encode_docs(docs, vocab)
    queries = [[f"t{rng.randint(vocab_n)}" for _ in range(rng.randint(1, 10))]
               for _ in range(n_queries)]
    qids, qw = encode_queries(queries, vocab, T)
    return vocab, coo, qids, qw


def _special_queries(j, qids, qw):
    """Add a duplicate-slot query, an empty query and one of 20 active head
    terms (more than the cap of 16)."""
    heads = np.where(np.asarray(j.head_slot) >= 0)[0]
    qids, qw = qids.copy(), qw.copy()
    qids[1, :6] = [heads[0], heads[1]] * 3
    qw[1, :6] = [1.0, 2.0, 0.5, 1.0, 1.0, 3.0]
    qw[2] = 0.0
    m = min(20, len(heads))
    qids[3, :m] = heads[:m]
    qw[3, :m] = 1.5
    return qids, qw


@pytest.mark.parametrize("head_size,head_dtype", [
    (8, "float32"), (64, "float32"), (None, "float32"), (64, "bfloat16")])
def test_head_scores_plain_matches_pallas(head_size, head_dtype):
    vocab, coo, qids, qw = _sparse_world(seed=head_size or 1)
    cfg = IndexConfig(doc_pad_multiple=128, nnz_pad_multiple=64,
                      head_budget_bytes=1 << 18, head_dtype=head_dtype)
    j = build_index(*coo, vocab.size, index_cfg=cfg, head_size=head_size)
    t = carry_sparse(j)
    qids, qw = _special_queries(j, qids, qw)
    got_j = np.asarray(head_scores_pallas(j, jnp.asarray(qids),
                                          jnp.asarray(qw), interpret=True))
    before = dict(cuda_build.launches)
    tq, tw = torch.from_numpy(qids), torch.from_numpy(qw)
    got_t = head_scores.head_scores(t, tq, tw).numpy()
    assert cuda_build.launches == before
    _, _, n_active = head_scores._prep_terms(t, tq, tw)
    over = (n_active > 16).numpy()
    assert over.any() == (head_size is None or head_size >= 20)
    assert np.allclose(got_t[2], 0.0)
    # rows under the cap: the same term order; XLA:CPU contracts the
    # interpreted kernel's `out += qw * row` into an FMA, where the port
    # rounds the product and then the sum, so each term may differ by an ulp
    np.testing.assert_allclose(got_t[~over], got_j[~over], rtol=1e-6,
                               atol=1e-6)
    # overflowed rows: the full-head product on both sides
    np.testing.assert_allclose(got_t[over], got_j[over], rtol=1e-5, atol=1e-6)
    # and against the port's capped gather engine (bmm per 16 terms)
    capped, cap_over = _head_scores_capped(t, tq.clamp(0, t.vocab_size - 1),
                                           tw, 16)
    np.testing.assert_array_equal(cap_over.numpy(), over)
    np.testing.assert_allclose(got_t[~over], capped.numpy()[~over],
                               rtol=1e-5, atol=1e-6)
    # and against the XLA full scorer, at tests/test_pallas.py's bounds
    ref = np.asarray(_head_scores(j, jnp.clip(jnp.asarray(qids), 0,
                                              vocab.size - 1), jnp.asarray(qw)))
    tol = dict(rtol=2e-2, atol=1e-2) if head_dtype == "bfloat16" \
        else dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_t, ref, **tol)


def test_head_scores_int8_and_gate():
    vocab, coo, qids, qw = _sparse_world(seed=2)
    cfg = IndexConfig(doc_pad_multiple=128, nnz_pad_multiple=64,
                      head_budget_bytes=1 << 18, head_dtype="int8")
    t = carry_sparse(build_index(*coo, vocab.size, index_cfg=cfg,
                                 head_size=32))
    assert not head_scores.head_scores_available(t)     # int8, and the CPU
    with pytest.raises(NotImplementedError):
        head_scores.head_scores(t, torch.from_numpy(qids),
                                torch.from_numpy(qw))
    f32 = dataclasses.replace(t, head_rows=t.head_rows.float())
    assert not head_scores.head_scores_available(f32)   # a CPU head
