"""The port's doc-sharded BM25 engines against ``tdr/parallel`` on CPU.

``tdr`` runs on the 8 virtual CPU devices that conftest.py sets up; the
port runs on a mesh whose entries are all ``"cpu"`` (one controller; a
mesh may repeat a device).  Both get the same COO arrays and query
matrices (numpy, from seeds), and are held to ``tests/test_parallel.py``'s
tolerances: scores within rtol 1e-4 / atol 1e-5, global rows equal
wherever a score is not within 1e-6 of a neighbour.
"""

import numpy as np
import pytest

from tests.torch_threads import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tdr import parallel as jpar  # noqa: E402
from tdr.data import SyntheticSpec, synthetic_corpus  # noqa: E402
from tdr.parallel import sharded as jsharded  # noqa: E402
from tdr.text import (build_vocab, encode_docs, encode_queries,  # noqa: E402
                      preprocess_texts)
from tdr.utils.config import IndexConfig  # noqa: E402
from tdr_torch import parallel as tpar  # noqa: E402
from tdr_torch.index.build import build_index as t_build_index  # noqa: E402
from tdr_torch.ops.score import score_and_topk as t_score_and_topk  # noqa: E402
from tdr_torch.parallel import sharded as tsharded  # noqa: E402
from tdr_torch.utils import config as tconfig  # noqa: E402
from test_torch_router import _native_built_once  # noqa: E402

_CFG = dict(doc_pad_multiple=8, nnz_pad_multiple=64, head_budget_bytes=1 << 20,
            head_dtype="float32")
J_CFG = IndexConfig(**_CFG)
T_CFG = tconfig.IndexConfig(**_CFG)
# a head budget that leaves a tail in every shard (K1's plain version runs)
_TAIL = dict(_CFG, head_budget_bytes=1 << 12, head_dtype="bfloat16")


def cpu_mesh(data=1, model=1):
    return tpar.make_mesh(data=data, model=model,
                          devices=["cpu"] * (data * model))


@pytest.fixture(scope="module")
def world():
    corpus, queries = synthetic_corpus(
        SyntheticSpec(n_docs=300, n_queries=24, seed=17, ref_proportions=False,
                      langs=("en",)))
    toks = preprocess_texts(corpus.texts, corpus.langs)
    vocab = build_vocab(toks)
    coo = encode_docs(toks, vocab)
    qtoks = preprocess_texts(queries.queries, queries.langs)
    qids, qw = encode_queries(qtoks, vocab, max_terms=16)
    return vocab, coo, qids, qw


def assert_parallel_topk(tv, tr, jv, jr, rtol=1e-4, atol=1e-5, margin=1e-6):
    """``tests/test_parallel.py``'s check: values close, rows equal wherever
    the reference's score stands ``margin`` clear of both neighbours."""
    tv, tr, jv, jr = (np.asarray(x) for x in (tv, tr, jv, jr))
    assert tv.shape == jv.shape and tr.shape == jr.shape
    np.testing.assert_allclose(tv, jv, rtol=rtol, atol=atol)
    k = jv.shape[1]
    for q in range(jv.shape[0]):
        strict = np.isfinite(jv[q])
        strict[:-1] &= jv[q, :-1] > jv[q, 1:] + margin
        strict[1:] &= jv[q, 1:] < jv[q, :-1] - margin
        np.testing.assert_array_equal(tr[q][strict], jr[q][strict])
    assert k == tv.shape[1]


def _both_sharded(coo, vocab_size, n_shards, jcfg=J_CFG, tcfg=T_CFG):
    js = jpar.build_sharded_index(*coo, vocab_size, n_shards=n_shards,
                                  index_cfg=jcfg)
    ts = tpar.build_sharded_index(*coo, vocab_size, n_shards=n_shards,
                                  index_cfg=tcfg, devices=["cpu"] * n_shards)
    return js, ts


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_sharded_matches_tdr(world, n_shards):
    vocab, coo, qids, qw = world
    js, ts = _both_sharded(coo, vocab.size, n_shards)
    assert ts.n_docs_pad_local == js.n_docs_pad_local
    assert (ts.head_size, ts.tail_pmax) == (js.head_size, js.tail_pmax)
    jv, jr = jpar.sharded_score_topk(jpar.make_mesh(data=n_shards), js,
                                     jnp.asarray(qids), jnp.asarray(qw), 10)
    tv, tr = tpar.sharded_score_topk(cpu_mesh(n_shards), ts,
                                     torch.from_numpy(qids),
                                     torch.from_numpy(qw), 10)
    assert_parallel_topk(tv, tr, jv, jr)
    np.testing.assert_array_equal(
        tsharded.global_row_to_doc(ts, tr.numpy())[np.isfinite(tv.numpy())],
        jsharded.global_row_to_doc(js, np.asarray(jr))[
            np.isfinite(np.asarray(jv))])


@pytest.mark.parametrize("n_shards", [2, 4])
def test_tail_bearing_shards_match_tdr(world, n_shards):
    """Every shard has a tail: the port's K1 (plain version here) against
    ``tdr``'s sort compactor, bf16 heads."""
    vocab, coo, qids, qw = world
    js, ts = _both_sharded(coo, vocab.size, n_shards, IndexConfig(**_TAIL),
                           tconfig.IndexConfig(**_TAIL))
    assert 0 < ts.head_size < ts.vocab_size
    for s in range(n_shards):
        np.testing.assert_array_equal(
            ts.stacked("head_rows")[s].view(torch.int16).numpy(),
            np.asarray(js.head_rows[s]).view(np.int16))
    jv, jr = jpar.sharded_score_topk(jpar.make_mesh(data=n_shards), js,
                                     jnp.asarray(qids), jnp.asarray(qw), 10)
    tv, tr = tpar.sharded_score_topk(cpu_mesh(n_shards), ts,
                                     torch.from_numpy(qids),
                                     torch.from_numpy(qw), 10)
    assert_parallel_topk(tv, tr, jv, jr)


def test_sharded_matches_port_single_device(world):
    """The port's sharded engine against the port's single-device
    ``score_and_topk`` on the same corpus."""
    vocab, coo, qids, qw = world
    single = t_build_index(*coo, vocab.size, index_cfg=T_CFG, device="cpu")
    ts = tpar.build_sharded_index(*coo, vocab.size, n_shards=4,
                                  index_cfg=T_CFG, devices=["cpu"] * 4)
    q, w = torch.from_numpy(qids), torch.from_numpy(qw)
    v1, r1 = t_score_and_topk(single, q, w, 10)
    vs, rs = tpar.sharded_score_topk(cpu_mesh(4), ts, q, w, 10)
    assert_parallel_topk(vs, tsharded.global_row_to_doc(ts, rs), v1, r1)


def test_sharded_global_stats_injected(world):
    """Shard-local df must not drive idf: the port's shards carry ``tdr``'s
    global idf, avgdl, head selection and per-shard valid counts."""
    vocab, coo, _, _ = world
    js, ts = _both_sharded(coo, vocab.size, 4)
    np.testing.assert_allclose(ts.idf.numpy(), np.asarray(js.idf), rtol=1e-6)
    assert float(ts.avgdl) == pytest.approx(float(js.avgdl), rel=1e-6)
    np.testing.assert_array_equal(ts.head_slot.numpy(),
                                  np.asarray(js.head_slot))
    np.testing.assert_array_equal(ts.n_valid.numpy(), np.asarray(js.n_valid))
    for name in ("indptr", "postings_doc", "df_local", "doc_len"):
        np.testing.assert_array_equal(ts.stacked(name).numpy(),
                                      np.asarray(getattr(js, name)))
    np.testing.assert_allclose(ts.stacked("head_rows").numpy(),
                               np.asarray(js.head_rows), rtol=1e-6)


def test_spmd_global_stats_match_tdr(world):
    vocab, coo, _, _ = world
    doc_ids, term_ids, _, doc_lens = coo
    js, ts = _both_sharded(coo, vocab.size, 4)
    bounds = np.linspace(0, len(doc_lens), 5).astype(np.int64)
    shard_of = np.searchsorted(bounds[1:], doc_ids, side="right")
    nnz_pad = -(-int(np.bincount(shard_of, minlength=4).max()) // 64) * 64
    ti = np.full((4, nnz_pad), vocab.size, np.int32)
    for s in range(4):
        sel = term_ids[shard_of == s]
        ti[s, :len(sel)] = sel
    jdf, jtot = jsharded.spmd_global_stats(jpar.make_mesh(data=4),
                                           jnp.asarray(ti), js.doc_len,
                                           vocab.size)
    tdf, ttot = tpar.spmd_global_stats(cpu_mesh(4), torch.from_numpy(ti),
                                       ts.stacked("doc_len"), vocab.size)
    np.testing.assert_array_equal(tdf.numpy(), np.asarray(jdf))
    np.testing.assert_allclose(float(ttot), float(jtot), rtol=1e-6)


@pytest.mark.parametrize("grid", [(2, 4), (4, 2), (1, 8), (8, 1)])
def test_grid_matches_tdr(world, grid):
    n_data, n_model = grid
    vocab, coo, qids, qw = world
    js, ts = _both_sharded(coo, vocab.size, n_model)
    jv, jr = jpar.grid_score_topk(jpar.make_mesh(data=n_data, model=n_model),
                                  js, jnp.asarray(qids), jnp.asarray(qw), 10)
    tv, tr = tpar.grid_score_topk(cpu_mesh(n_data, n_model), ts,
                                  torch.from_numpy(qids),
                                  torch.from_numpy(qw), 10)
    assert_parallel_topk(tv, tr, jv, jr)


def test_grid_ragged_query_count(world):
    """Q = 7 over a data axis of 4: the padding must not leak."""
    vocab, coo, qids, qw = world
    js, ts = _both_sharded(coo, vocab.size, 2)
    jv, jr = jpar.grid_score_topk(jpar.make_mesh(data=4, model=2), js,
                                  jnp.asarray(qids[:7]), jnp.asarray(qw[:7]), 5)
    tv, tr = tpar.grid_score_topk(cpu_mesh(4, 2), ts,
                                  torch.from_numpy(qids[:7]),
                                  torch.from_numpy(qw[:7]), 5)
    assert tuple(tv.shape) == (7, 5)
    assert_parallel_topk(tv, tr, jv, jr)


@pytest.mark.parametrize("n_data", [2, 8])
def test_dp_matches_tdr(world, n_data):
    """Query data parallelism: values within rtol 1e-5, rows equal."""
    from tdr.index import build_index as j_build_index

    vocab, coo, qids, qw = world
    jix = j_build_index(*coo, vocab.size, index_cfg=J_CFG)
    tix = t_build_index(*coo, vocab.size, index_cfg=T_CFG, device="cpu")
    jv, jr = jpar.dp_score_topk(jpar.make_mesh(data=n_data), jix,
                                jnp.asarray(qids[:21]), jnp.asarray(qw[:21]),
                                10)
    tv, tr = tpar.dp_score_topk(cpu_mesh(n_data), tix,
                                torch.from_numpy(qids[:21]),
                                torch.from_numpy(qw[:21]), 10)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def test_sharded_determinism(world):
    vocab, coo, qids, qw = world
    ts = tpar.build_sharded_index(*coo, vocab.size, n_shards=4,
                                  index_cfg=T_CFG, devices=["cpu"] * 4)
    q, w = torch.from_numpy(qids), torch.from_numpy(qw)
    v1, r1 = tpar.sharded_score_topk(cpu_mesh(4), ts, q, w, 10)
    v2, r2 = tpar.sharded_score_topk(cpu_mesh(4), ts, q, w, 10)
    assert torch.equal(v1, v2) and torch.equal(r1, r2)


def test_make_mesh_rules():
    """A mesh over repeated devices; no devices means CUDA, which raises
    here (no card, ``resolve_device``'s rule)."""
    mesh = cpu_mesh(4, 2)
    assert mesh.shape == {"data": 4, "model": 2} and mesh.size == 8
    assert mesh.axis_devices("model", 3) == [torch.device("cpu")] * 2
    mesh = tpar.make_mesh(data=0, model=2, devices=["cpu"] * 7)
    assert mesh.shape == {"data": 3, "model": 2}
    with pytest.raises(ValueError):
        tpar.make_mesh(data=4, devices=["cpu"] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tpar.make_mesh()


def test_collectives():
    from tdr_torch.parallel.mesh import all_gather, psum, psum_scatter

    mesh = cpu_mesh(4)
    x = torch.arange(24.0).view(4, 6)
    blocks = tpar.data_sharding(mesh, x)
    assert [tuple(b.shape) for b in blocks] == [(1, 6)] * 4
    assert torch.equal(all_gather(blocks, "cpu")[:, 0], x)
    assert all(r is x for r in tpar.replicated(mesh, x))
    parts = [x * (i + 1) for i in range(4)]
    assert torch.equal(psum(parts, "cpu"), x * 10)
    tiled = psum_scatter([p[:, :4] for p in parts], ["cpu"] * 4, dim=1)
    assert torch.equal(torch.cat(tiled, dim=1), x[:, :4] * 10)
    untiled = psum_scatter(parts, ["cpu"] * 4, dim=0, tiled=False)
    assert torch.equal(torch.stack(untiled), x * 10)
    with pytest.raises(ValueError):
        tpar.data_sharding(mesh, x[:3])


def _router_world():
    corpus, queries = synthetic_corpus(
        SyntheticSpec(n_docs=200, n_queries=20, seed=61, ref_proportions=False,
                      langs=("en",)))
    toks = preprocess_texts(corpus.texts, corpus.langs)
    return corpus, queries, toks


@pytest.mark.parametrize("layout,grid", [("doc", (4, 1)), ("grid", (4, 2))])
def test_sharded_model_in_router(layout, grid):
    """``ShardedBM25Model`` in a ``LanguageRouter`` (the mix the router
    allows): the port's lists equal ``tdr``'s (its own sharded model over
    the same tokens) but for near-ties, and recall@10 >= 0.95."""
    from tdr.eval import recall_at_k
    from tdr.rank import LanguageRouter as JRouter
    from tdr_torch.rank import LanguageRouter as TRouter

    corpus, queries, toks = _router_world()
    jm = jsharded.ShardedBM25Model.build(
        toks, corpus.docids, jpar.make_mesh(data=grid[0], model=grid[1]),
        index_cfg=J_CFG, layout=layout)
    tm = tsharded.ShardedBM25Model.build(
        toks, corpus.docids, cpu_mesh(*grid), index_cfg=T_CFG, layout=layout)
    assert tm.sindex.n_shards == (grid[0] if layout == "doc" else grid[1])
    j_docs, j_scores = JRouter({"en": jm}, query_batch=8).retrieve_with_scores(
        queries.queries, queries.langs, k=10)
    t_docs, t_scores = TRouter({"en": tm}, query_batch=8,
                               use_native=False).retrieve_with_scores(
        queries.queries, queries.langs, k=10)
    np.testing.assert_allclose(t_scores, j_scores, rtol=1e-4, atol=1e-5)
    for q, (a, b) in enumerate(zip(t_docs, j_docs)):
        for j in np.nonzero(np.array(a) != np.array(b))[0]:
            near = np.isclose(j_scores[q], j_scores[q, j], rtol=1e-4,
                              atol=1e-5)
            assert near.sum() >= 2, f"query {q} rank {j}"
    assert recall_at_k(t_docs, queries.positive_docs) >= 0.95


def test_router_mixes_sharded_and_single():
    """One language sharded, one single-device, in one router: each
    language's lists equal those of its single-device model."""
    from tdr_torch.models.sparse import BM25Model
    from tdr_torch.rank import LanguageRouter
    from tdr_torch.text.preprocess import Preprocessor

    corpus, queries = synthetic_corpus(
        SyntheticSpec(n_docs=240, n_queries=24, seed=29, ref_proportions=False,
                      langs=("en", "fr")))
    pp = Preprocessor("best")
    models, mixed = {}, {}
    for lang in ("en", "fr"):
        rows = [i for i, l in enumerate(corpus.langs) if l == lang]
        toks = [pp(corpus.texts[i], lang) for i in rows]
        ids = [corpus.docids[i] for i in rows]
        models[lang] = BM25Model.build(toks, ids, lang=lang, index_cfg=T_CFG,
                                       device="cpu")
        mixed[lang] = models[lang]
    en_rows = [i for i, l in enumerate(corpus.langs) if l == "en"]
    mixed["en"] = tsharded.ShardedBM25Model.build(
        [pp(corpus.texts[i], "en") for i in en_rows],
        [corpus.docids[i] for i in en_rows], cpu_mesh(4), index_cfg=T_CFG,
        head_size=models["en"].index.head_size)
    base = LanguageRouter(models, query_batch=8, use_native=False)
    got = LanguageRouter(mixed, query_batch=8, use_native=False)
    b_docs, b_scores = base.retrieve_with_scores(queries.queries,
                                                 queries.langs, k=10)
    g_docs, g_scores = got.retrieve_with_scores(queries.queries,
                                                queries.langs, k=10)
    np.testing.assert_allclose(g_scores, b_scores, rtol=1e-4, atol=1e-5)
    for q, (a, b) in enumerate(zip(g_docs, b_docs)):
        for j in np.nonzero(np.array(a) != np.array(b))[0]:
            assert np.isclose(b_scores[q], b_scores[q, j], rtol=1e-4,
                              atol=1e-5).sum() >= 2, f"query {q} rank {j}"


class TestPipelinedCascade:
    """Stage 1 on one device, stage 2 on another: lists equal the port's
    ``CascadeRetriever`` and ``tdr``'s ``PipelinedCascade``."""

    def _models(self):
        from tdr.models import BM25Model as JBM25, TfidfCosineModel as JTfidf
        from tdr_torch.models.sparse import BM25Model, TfidfCosineModel
        from tdr_torch.text.preprocess import Preprocessor
        from tdr_torch.text.vocab import Vocab as TVocab

        corpus, queries = synthetic_corpus(
            SyntheticSpec(n_docs=400, n_queries=40, seed=9, hard=True,
                          langs=("en",), ref_proportions=False))
        pp = Preprocessor("best")
        toks = [pp(t, "en") for t in corpus.texts]
        jcfg = IndexConfig(head_budget_bytes=1 << 18)
        tcfg = tconfig.IndexConfig(head_budget_bytes=1 << 18)
        jv = build_vocab(toks)
        coo = encode_docs(toks, jv)
        tv = TVocab(jv.term_to_id, jv.df, jv.n_docs, pair_to_id=jv.pair_to_id)
        t = (TfidfCosineModel.from_coo(tv, coo, corpus.docids, index_cfg=tcfg,
                                       device="cpu"),
             BM25Model.from_coo(tv, coo, corpus.docids, index_cfg=tcfg,
                                device="cpu"))
        j = (JTfidf.from_coo(jv, coo, corpus.docids, index_cfg=jcfg),
             JBM25.from_coo(jv, coo, corpus.docids, index_cfg=jcfg))
        assert t[1].index.head_size < t[1].index.vocab_size
        return t, j, queries

    def test_matches_cascade_and_tdr(self):
        from tdr.parallel import PipelinedCascade as JPipe
        from tdr_torch.rank import CascadeRetriever

        _native_built_once()
        (cand, rank), (jcand, jrank), queries = self._models()
        pipe = tpar.PipelinedCascade(cand, rank, stage1_device="cpu",
                                     stage2_device="cpu", candidates=50,
                                     query_batch=16)
        got = pipe.retrieve(queries.queries, "en", k=10)
        want = CascadeRetriever({"en": cand}, {"en": rank}, candidates=50,
                                query_batch=16).retrieve(
            queries.queries, ["en"] * len(queries.queries), k=10)
        assert got == want
        devs = jax.devices()
        jgot = JPipe(jcand, jrank, stage1_device=devs[0],
                     stage2_device=devs[1], candidates=50,
                     query_batch=16).retrieve(queries.queries, "en", k=10)
        same = sum(a == b for a, b in zip(got, jgot))
        assert same == len(got), f"{same} of {len(got)} lists equal"

    def test_stage_indexes_live_on_their_devices(self):
        (cand, rank), _, _ = self._models()
        pipe = tpar.PipelinedCascade(cand, rank, stage1_device="cpu",
                                     stage2_device=torch.device("cpu"))
        assert pipe._idx1.head_rows.device == pipe.stage1_device
        assert pipe._idx2.head_rows.device == pipe.stage2_device
        assert pipe._idx1.postings_w.device == pipe.stage1_device
        with pytest.raises(ValueError):
            import dataclasses

            tpar.PipelinedCascade(cand, dataclasses.replace(
                rank, docids=rank.docids[::-1]), "cpu", "cpu")
