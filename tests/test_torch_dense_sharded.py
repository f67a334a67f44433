"""The port's doc-sharded dense flat search against ``tdr/parallel/dense.py``
on CPU: ip and l2, bf16 / f32 / int8 storage, uneven shards, small k, and
Rocchio feedback with its psum-merged centroid.

The same seeded numpy embeddings and queries go to both; ``tdr`` runs on
its 8 virtual CPU devices (S of them), the port on a mesh of S ``"cpu"``
entries.  Tolerances are ``tests/test_dense_sharded.py``'s; rows must be
equal wherever the reference's scores are untied.
"""

import numpy as np
import pytest

from tests.torch_threads import torch

import jax.numpy as jnp  # noqa: E402

from tdr import parallel as jpar  # noqa: E402
from tdr_torch import parallel as tpar  # noqa: E402
from tdr_torch.models.dense import (build_flat_index,  # noqa: E402
                                    flat_search, flat_search_prf)
from test_torch_parallel import cpu_mesh  # noqa: E402

N_DOCS, DIM, Q, K = 1000, 32, 16, 10


def _world(seed=0, normalized=True):
    rng = np.random.RandomState(seed)
    emb = rng.randn(N_DOCS, DIM).astype(np.float32)
    q = rng.randn(Q, DIM).astype(np.float32)
    if normalized:
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    return emb, q


def _clustered(seed):
    rng = np.random.RandomState(seed)
    centers = rng.randn(4, DIM).astype(np.float32) * 3
    emb = np.concatenate(
        [c + 0.3 * rng.randn(64, DIM).astype(np.float32) for c in centers])
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = emb[list(range(0, 256, 17))] + \
        0.4 * rng.randn(16, DIM).astype(np.float32)
    return emb, q / np.linalg.norm(q, axis=1, keepdims=True)


def _both(emb, q, n_shards, top_k=K, prf=False, **kw):
    build = dict(kw)
    js = jpar.build_sharded_flat_index(emb, n_shards=n_shards, **build)
    ts = tpar.build_sharded_flat_index(emb, n_shards=n_shards,
                                       devices=["cpu"] * n_shards, **build)
    jfn = jpar.sharded_flat_search_prf if prf else jpar.sharded_flat_search
    tfn = tpar.sharded_flat_search_prf if prf else tpar.sharded_flat_search
    extra = dict(n_feedback=5, alpha=0.6) if prf else {}
    jv, jr = jfn(jpar.make_mesh(data=n_shards), js, jnp.asarray(q),
                 top_k=top_k, **extra)
    tv, tr = tfn(cpu_mesh(n_shards), ts, torch.from_numpy(q), top_k=top_k,
                 **extra)
    return js, ts, tv.numpy(), tr.numpy(), np.asarray(jv), np.asarray(jr)


def assert_untied_rows(tr, jr, jv):
    untied = np.isfinite(jv)
    untied[:, 1:] &= jv[:, 1:] != jv[:, :-1]
    untied[:, :-1] &= jv[:, :-1] != jv[:, 1:]
    np.testing.assert_array_equal(tr[untied], jr[untied])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_ip_matches_tdr(dtype, n_shards):
    emb, q = _world()
    js, ts, tv, tr, jv, jr = _both(emb, q, n_shards, pad_multiple=64,
                                   dtype=dtype)
    assert ts.n_loc_pad == js.n_loc_pad
    if dtype == "int8":
        for s in range(n_shards):
            np.testing.assert_array_equal(ts.embeddings[s].numpy(),
                                          np.asarray(js.embeddings[s]))
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-6)
    assert_untied_rows(tr, jr, jv)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_l2_matches_tdr(dtype):
    emb, q = _world(seed=3, normalized=False)
    _, _, tv, tr, jv, jr = _both(emb, q, 8, pad_multiple=64, metric="l2",
                                 dtype=dtype)
    np.testing.assert_allclose(tv, jv, rtol=1e-4, atol=1e-4)
    assert_untied_rows(tr, jr, jv)


def test_uneven_docs_and_small_k():
    """777 docs over 8 shards: padding rows never win, k = 5 is the exact
    f32 order."""
    rng = np.random.RandomState(1)
    emb = rng.randn(777, 16).astype(np.float32)
    q = rng.randn(4, 16).astype(np.float32)
    js, ts, tv, tr, jv, jr = _both(emb, q, 8, top_k=5, pad_multiple=8,
                                   dtype="float32")
    docs = tpar.sharded_row_to_doc(ts, tr)
    assert np.all(docs[np.isfinite(tv)] < 777)
    np.testing.assert_array_equal(docs, np.argsort(-(emb @ q.T), axis=0)[:5].T)
    np.testing.assert_array_equal(docs, jpar.sharded_row_to_doc(js, jr))
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-6)


def test_k_beyond_shard_rows():
    """k larger than a shard's padded rows: every shard contributes all its
    rows, padded -inf entries pin to the shard's row 0."""
    rng = np.random.RandomState(5)
    emb = rng.randn(20, 8).astype(np.float32)
    q = rng.randn(3, 8).astype(np.float32)
    _, ts, tv, tr, jv, jr = _both(emb, q, 4, top_k=12, pad_multiple=8,
                                  dtype="float32")
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tr, jr)


def test_approx_is_exact():
    emb, q = _world(seed=7)
    ts = tpar.build_sharded_flat_index(emb, 8, pad_multiple=64,
                                       devices=["cpu"] * 8)
    a = tpar.sharded_flat_search(cpu_mesh(8), ts, torch.from_numpy(q), K)
    b = tpar.sharded_flat_search(cpu_mesh(8), ts, torch.from_numpy(q), K,
                                 approx=True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("n_shards", [2, 8])
def test_prf_matches_tdr(dtype, n_shards):
    emb, q = _clustered(11)
    _, _, tv, tr, jv, jr = _both(emb, q, n_shards, prf=True, pad_multiple=64,
                                 dtype=dtype)
    np.testing.assert_allclose(tv, jv, rtol=1e-4, atol=1e-5)
    assert_untied_rows(tr, jr, jv)


@pytest.mark.parametrize("metric,dtype", [("ip", "bfloat16"),
                                          ("ip", "int8"), ("l2", "bfloat16")])
def test_matches_port_single_device(metric, dtype):
    """The port's sharded search and feedback against the port's
    single-device ``flat_search`` / ``flat_search_prf``."""
    emb, q = _clustered(12)
    flat = build_flat_index(emb, pad_multiple=64, metric=metric, dtype=dtype,
                            device="cpu")
    ts = tpar.build_sharded_flat_index(emb, 4, pad_multiple=64, metric=metric,
                                       dtype=dtype, devices=["cpu"] * 4)
    qt = torch.from_numpy(q)
    for single, sharded in (
            (flat_search(flat, qt, K),
             tpar.sharded_flat_search(cpu_mesh(4), ts, qt, K)),
            (flat_search_prf(flat, qt, K, n_feedback=5, alpha=0.6),
             tpar.sharded_flat_search_prf(cpu_mesh(4), ts, qt, K,
                                          n_feedback=5, alpha=0.6))):
        v1, r1 = (x.numpy() for x in single)
        vs, rs = (x.numpy() for x in sharded)
        np.testing.assert_allclose(vs, v1, rtol=1e-5, atol=1e-5)
        assert_untied_rows(tpar.sharded_row_to_doc(ts, rs), r1, v1)
