"""The dense path in the port against the JAX package, on CPU: the hash
tokenizer, the ``DualEncoder`` forward on flax weights carried across, IVF
build and search, ``flat_search_prf`` and ``DenseModel.retrieve``.

The encoder runs at a small width (dim 128, depth 2, 4 heads, 32 tokens).
In f32 the two forwards agree within 1e-5 per entry; in bf16 they round at
the same points but sum in other orders, so the bound is a cosine of at
least 0.999 per row.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from tests.torch_threads import torch

import flax  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tdr.data import SyntheticSpec, synthetic_corpus  # noqa: E402
from tdr.models import dense as jdense  # noqa: E402
from tdr.models import encoder as jenc  # noqa: E402
from tdr.text import hash_tokenizer as jht  # noqa: E402
from tdr.utils.config import DenseConfig as JDenseConfig  # noqa: E402
from tdr_torch.models import dense as tdense  # noqa: E402
from tdr_torch.models import encoder as tenc  # noqa: E402
from tdr_torch.text import hash_tokenizer as tht  # noqa: E402
from tdr_torch.utils.config import DenseConfig  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(vocab_size=1000, dim=128, depth=2, heads=4, max_len=32)
TEXTS = [
    "The quick brown fox jumps over the lazy dog",
    "",                                            # CLS only
    "Donaudampfschifffahrtsgesellschaft und Straßenbahnhaltestelle " * 4,
    "l'éducation nationale française, les élèves",
    "한국어 문장 처리와 형태소 분석",
    "مرحبا بالعالم العربي",
    "a b c",
    "word " * 60,                                  # truncated at max_len
]


def _native_built_once():
    """Build the port's native tokenizer under a file lock: test workers
    must not run its lazy `make` at the same time."""
    import fcntl
    import tempfile

    path = os.path.join(tempfile.gettempdir(), "tdr_torch_native.lock")
    with open(path, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        from tdr_torch import native

        assert native.available()


# -- hash tokenizer -----------------------------------------------------------

def test_hash_tokenizer_matches_jax_package():
    _native_built_once()
    for t in TEXTS:
        for V, L in ((1000, 32), (50_000, 128)):
            assert tht.encode_text(t, V, L) == jht.encode_text(t, V, L)
    for V, L in ((1000, 32), (50_000, 128)):
        ji, jm = jht.encode_batch(TEXTS, V, L)
        for ti, tm in (tht.encode_batch(TEXTS, V, L),
                       tht.encode_batch_python(TEXTS, V, L)):
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tm, jm)
            assert ti.dtype == np.int32 and tm.dtype == np.float32


# -- encoder ------------------------------------------------------------------

_ENC = {}


def _encoders(dtype):
    """(flax model, flax params, port model with the same weights)."""
    if dtype not in _ENC:
        jm, jp = jenc.init_encoder(JDenseConfig(**SMALL, dtype=dtype), seed=3)
        params = jax.tree_util.tree_map(np.asarray, flax.linen.meta.unbox(jp))
        tm = tenc.DualEncoder(DenseConfig(**SMALL, dtype=dtype))
        tm.load_state_dict(tenc.encoder_state_from_flax(params))
        _ENC[dtype] = (jm, jp, tm.eval())
    return _ENC[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_flax(dtype):
    jm, jp, tm = _encoders(dtype)
    ids, mask = jht.encode_batch(TEXTS, SMALL["vocab_size"], SMALL["max_len"])
    assert (mask == 0).any() and mask[1].sum() == 1   # padding, an empty text
    je = np.asarray(jenc.encode(jm, jp, jnp.asarray(ids), jnp.asarray(mask)))
    te = tenc.encode(tm, ids, mask)
    assert te.dtype == torch.float32 and not te.requires_grad
    te = te.numpy()
    assert np.isfinite(te).all()
    np.testing.assert_allclose(np.linalg.norm(te, axis=1), 1.0, rtol=1e-5)
    if dtype == "float32":
        np.testing.assert_allclose(te, je, atol=1e-5, rtol=0)
    else:
        assert (te * je).sum(axis=1).min() >= 0.999


def test_init_encoder_shapes_and_seed(monkeypatch):
    cfg = DenseConfig(**SMALL)
    a = tenc.init_encoder(cfg, seed=1, device="cpu")
    b = tenc.init_encoder(cfg, seed=1, device="cpu")
    c = tenc.init_encoder(cfg, seed=2, device="cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    _, jp, tm = _encoders("bfloat16")
    assert {k: v.shape for k, v in sa.items()} == \
        {k: v.shape for k, v in tm.state_dict().items()}
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["tok_embed.weight"], sc["tok_embed.weight"])
    # flax's distributions: normal(0.02) embeddings, xavier-uniform kernels
    assert abs(sa["tok_embed.weight"].std().item() - 0.02) < 1e-3
    w = sa["blocks.0.mlp.up.weight"]
    limit = (6.0 / (w.shape[0] + w.shape[1])) ** 0.5
    assert w.abs().max().item() <= limit and w.abs().max().item() > 0.9 * limit
    assert torch.equal(sa["blocks.1.attn.out.bias"], torch.zeros(128))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tenc.init_encoder(cfg)
    with pytest.raises(RuntimeError):
        tdense.build_flat_index(np.zeros((4, 8), np.float32))


def test_dense_defaults_match_jax_package():
    assert DenseConfig() == DenseConfig(**{
        f: getattr(JDenseConfig(), f) for f in DenseConfig.__dataclass_fields__})
    d = DenseConfig()
    assert (d.vocab_size, d.dim, d.depth, d.heads, d.mlp_ratio, d.max_len,
            d.dtype) == (50_000, 384, 6, 12, 4.0, 128, "bfloat16")


# -- flat index build ---------------------------------------------------------

@pytest.mark.parametrize("dtype,metric", [("bfloat16", "ip"), ("int8", "l2"),
                                          ("bfloat16", "l2")])
def test_build_flat_index_matches_jax(dtype, metric):
    rng = np.random.RandomState(2)
    emb = rng.randn(300, 64).astype(np.float32)
    j = jdense.build_flat_index(emb, metric=metric, dtype=dtype)
    for src in (emb, torch.from_numpy(emb)):
        t = tdense.build_flat_index(src, metric=metric, dtype=dtype,
                                    device="cpu")
        assert t.n_docs == j.n_docs and t.metric == j.metric
        np.testing.assert_array_equal(
            t.embeddings.float().numpy(),
            np.asarray(j.embeddings.astype(jnp.float32)))
        for name in ("doc_sq", "doc_scale"):
            jx, tx = getattr(j, name), getattr(t, name)
            assert (jx is None) == (tx is None)
            if jx is not None:
                np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))


# -- IVF and PRF ----------------------------------------------------------------

def _clustered(seed=0, n=600, d=32, k=8):
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, d).astype(np.float32) * 3
    x = centers[rng.randint(0, k, size=n)] + rng.randn(n, d).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _carry_ivf(j):
    arrays = {k: np.asarray(getattr(j, k)) for k in (
        "centroids", "buckets", "bucket_rows", "bucket_counts")}
    if j.bucket_scale is not None:
        arrays["bucket_scale"] = np.asarray(j.bucket_scale)
    meta = {"n_docs": j.n_docs, "nlist": j.nlist, "bucket_pad": j.bucket_pad}
    return tdense.ivf_index_from_arrays(arrays, meta, device="cpu")


def _assert_same_ivf(t, j):
    assert (t.n_docs, t.nlist, t.bucket_pad) == (j.n_docs, j.nlist, j.bucket_pad)
    np.testing.assert_array_equal(t.bucket_rows.numpy(), np.asarray(j.bucket_rows))
    np.testing.assert_array_equal(t.bucket_counts.numpy(),
                                  np.asarray(j.bucket_counts))
    np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids),
                               atol=1e-5)
    assert t.buckets.dtype == {jnp.int8: torch.int8,
                               jnp.float32: torch.float32}[j.buckets.dtype.type]
    np.testing.assert_array_equal(t.buckets.numpy(), np.asarray(j.buckets))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_build_ivf_index_with_jax_init_rows(dtype):
    emb = _clustered()
    j = jdense.build_ivf_index(emb, nlist=8, iters=6, seed=4, dtype=dtype)
    init = np.asarray(jax.random.choice(jax.random.PRNGKey(4), emb.shape[0],
                                        (8,), replace=False))
    t = tdense.build_ivf_index(emb, nlist=8, iters=6, dtype=dtype,
                               init_rows=init, device="cpu")
    _assert_same_ivf(t, j)


def test_build_ivf_index_device_with_jax_init_rows():
    emb = _clustered(seed=1, n=900)
    j = jdense.build_ivf_index_device(jnp.asarray(emb), nlist=8, iters=5,
                                      seed=2, dtype="int8")
    # train_subsample defaults to >= 4096 rows: k-means trains on all 900
    init = np.asarray(jax.random.choice(jax.random.PRNGKey(2), emb.shape[0],
                                        (8,), replace=False))
    t = tdense.build_ivf_index_device(torch.from_numpy(emb), nlist=8, iters=5,
                                      dtype="int8", init_rows=init)
    _assert_same_ivf(t, j)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_ivf_search_on_carried_index(dtype):
    emb = _clustered(seed=5)
    j = jdense.build_ivf_index(emb, nlist=8, iters=4, dtype=dtype)
    t = _carry_ivf(j)
    q = _clustered(seed=6, n=17)
    for nprobe in (1, 3, 8):
        jv, jr = jdense.ivf_search(j, jnp.asarray(q), top_k=10, nprobe=nprobe)
        tv, tr = tdense.ivf_search(t, torch.from_numpy(q), top_k=10,
                                   nprobe=nprobe)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                                   atol=1e-6)
        assert (tr.numpy() == np.asarray(jr)).mean() > 0.99
    # more results asked for than one bucket holds: -inf padding, row 0
    jv, jr = jdense.ivf_search(j, jnp.asarray(q), top_k=200, nprobe=1)
    tv, tr = tdense.ivf_search(t, torch.from_numpy(q), top_k=200, nprobe=1)
    np.testing.assert_array_equal(np.isfinite(tv.numpy()),
                                  np.isfinite(np.asarray(jv)))


@pytest.mark.parametrize("dtype,metric", [("bfloat16", "ip"), ("int8", "ip"),
                                          ("bfloat16", "l2")])
def test_flat_search_prf_matches_jax(dtype, metric):
    rng = np.random.RandomState(7)
    emb = rng.randn(8192 - 50, 128).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = rng.randn(6, 128).astype(np.float32)
    j = jdense.build_flat_index(emb, metric=metric, dtype=dtype)
    from test_torch_flat_kernels import assert_same_topk, carry_flat

    t = carry_flat(j)
    for jeng, teng in (("xla", "plain"), ("fused", "fused")):
        jv, jr = jdense.flat_search_prf(j, jnp.asarray(q), 10, engine=jeng)
        tv, tr = tdense.flat_search_prf(t, torch.from_numpy(q), 10,
                                        engine=teng)
        assert_same_topk(tv, tr, jv, jr, rtol=1e-5, atol=1e-5)
    a0v, a0r = tdense.flat_search_prf(t, torch.from_numpy(q), 10, alpha=0.0,
                                      engine="plain")
    pv, pr = tdense.flat_search(t, torch.from_numpy(q), 10, engine="plain")
    if metric == "ip":                       # alpha=0 is plain flat_search
        np.testing.assert_allclose(a0v.numpy(), pv.numpy(), rtol=1e-6)
        assert (a0r == pr).float().mean().item() > 0.95


# -- DenseModel ---------------------------------------------------------------

def test_dense_model_retrieve_matches_jax():
    _native_built_once()
    corpus, queries = synthetic_corpus(SyntheticSpec(n_docs=300, n_queries=40,
                                                     seed=7))
    jm, jp, tm = _encoders("float32")
    cfg = DenseConfig(**SMALL, dtype="float32")
    j = jdense.DenseModel.build(jm, jp, JDenseConfig(**SMALL, dtype="float32"),
                                corpus.texts, corpus.docids)
    t = tdense.DenseModel.build(tm, cfg, corpus.texts, corpus.docids)
    assert t.flat.n_docs == j.flat.n_docs == 300
    assert t.flat.embeddings.dtype == torch.bfloat16
    jres = j.retrieve(queries.queries, k=10)
    tres = t.retrieve(queries.queries, k=10)
    jq = jnp.asarray(j.encode_queries(queries.queries))
    jv, _ = map(np.asarray, jdense.flat_search(j.flat, jq, 10))
    tq = t.encode_queries(queries.queries)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-5)
    for i, (a, b) in enumerate(zip(tres, jres)):
        assert len(a) == len(b) == 10
        for r, (x, y) in enumerate(zip(a, b)):
            if x != y:      # only inside a near-tie of JAX's scores
                near = np.isclose(jv[i], jv[i, r], rtol=1e-5, atol=1e-5)
                assert near.sum() >= 2, f"query {i} rank {r}"
    jr = jdense.evaluate_dense(j, queries.queries, queries.positive_docs)
    tr = tdense.evaluate_dense(t, queries.queries, queries.positive_docs)
    assert tr["flat_recall"] == pytest.approx(jr["flat_recall"], abs=0.03)


def test_dense_modules_import_without_jax():
    code = (
        "import sys\n"
        "class B:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'flax', 'nltk', 'tdr'):\n"
        "            raise ImportError('blocked ' + name)\n"
        "sys.meta_path.insert(0, B())\n"
        "import tdr_torch.models.dense, tdr_torch.models.encoder\n"
        "import tdr_torch.ops.fused_flat, tdr_torch.ops.head_scores\n"
        "import tdr_torch.text.hash_tokenizer, chip_smoke\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
