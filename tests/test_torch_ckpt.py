"""Checkpoints in the port against the JAX package, on CPU (mirrors
tests/test_ckpt_cli.py): a file written by either package loads in the
other and scores the same — sparse models with bf16 and int8 heads,
registries, ``resume_dir``, dense models (flax's flatten order of the
encoder's param tree) and segment stores with their crash recovery.
"""

import os

import numpy as np
import pytest

from tests.torch_threads import torch

from tdr import ckpt as jckpt  # noqa: E402
from tdr.index import quantize_head as j_quantize  # noqa: E402
from tdr.models import sparse as jsparse  # noqa: E402
from tdr.utils.config import DenseConfig, IndexConfig  # noqa: E402
from tdr_torch import ckpt as tckpt  # noqa: E402
from tdr_torch.utils import config as tconfig  # noqa: E402
from test_torch_kernels import assert_same_topk  # noqa: E402
from test_torch_score_modes import CUMSUM_ATOL  # noqa: E402

CFG = dict(head_budget_bytes=1 << 15)


def _docs(seed=0, n=300, vocab_n=600):
    rng = np.random.RandomState(seed)
    return [[f"t{rng.randint(vocab_n)}" for _ in range(rng.randint(5, 50))]
            for _ in range(n)]


def _queries(docs, seed=1, n=16):
    rng = np.random.RandomState(seed)
    return [list(docs[rng.randint(len(docs))][:4]) for _ in range(n)]


def _jmodel(cls="BM25Model", int8=False, seed=0):
    docs = _docs(seed)
    m = getattr(jsparse, cls).build(docs, [f"d{i}" for i in range(len(docs))],
                                    index_cfg=IndexConfig(**CFG))
    if int8:
        import dataclasses

        m = dataclasses.replace(m, index=j_quantize(m.index))
    return docs, m


def _same_model(tm, jm, queries):
    tv, tr = tm.topk_tokens(queries, 10)
    jv, jr = jm.topk_tokens(queries, 10)
    assert_same_topk(tv, tr, jv, jr, rtol=1e-6, atol=CUMSUM_ATOL)


@pytest.mark.parametrize("cls,int8", [("BM25Model", False),
                                      ("BM25Model", True),
                                      ("TfidfCosineModel", False)])
def test_sparse_model_loads_both_ways(cls, int8, tmp_path):
    docs, jm = _jmodel(cls, int8)
    assert jm.index.head_size < jm.index.vocab_size
    assert (jm.index.head_scale is not None) == int8
    jckpt.save_sparse_model(str(tmp_path / "j"), jm)
    tm = tckpt.load_sparse_model(str(tmp_path / "j"), device="cpu")
    assert type(tm).__name__ == cls and tm.docids == jm.docids
    assert tm.vocab.term_to_id == jm.vocab.term_to_id
    assert (tm.index.head_rows.dtype == torch.int8) == int8
    q = _queries(docs)
    _same_model(tm, jm, q)
    tckpt.save_sparse_model(str(tmp_path / "t"), tm)
    jm2 = jckpt.load_sparse_model(str(tmp_path / "t"))
    for name in ("head_rows", "postings_w", "indptr", "head_slot"):
        np.testing.assert_array_equal(np.asarray(getattr(jm2.index, name)),
                                      np.asarray(getattr(jm.index, name)))
    _same_model(tm, jm2, q)


def test_use_fused_topk_false_scores_through_scatter(tmp_path):
    import dataclasses

    docs, jm = _jmodel()
    jm = dataclasses.replace(jm, use_fused_topk=False, tail_budget=512)
    jckpt.save_sparse_model(str(tmp_path / "m"), jm)
    tm = tckpt.load_sparse_model(str(tmp_path / "m"), device="cpu")
    assert not tm.use_fused_topk and tm.tail_budget == 512
    from tdr_torch.ops.score import score_and_topk

    q = _queries(docs)
    _same_model(tm, jm, q)
    qids, qw = tm.encode_query_tokens(q)
    v, r = tm._score_encoded(qids, qw, 10)
    sv, sr = score_and_topk(tm.index, qids, qw, 10)
    assert torch.equal(v, sv) and torch.equal(r, sr)


def test_registry_and_resume_dir(tmp_path):
    from test_torch_router import _native_built_once

    from tdr.data import SyntheticSpec, synthetic_corpus
    from tdr.rank import router as jrouter
    from tdr_torch.rank import router as trouter

    _native_built_once()
    corpus, queries = synthetic_corpus(SyntheticSpec(n_docs=500, n_queries=40,
                                                     seed=5, hard=True))
    budget = 2 << 20
    jm = jrouter.build_language_models(
        corpus, index_cfg=IndexConfig(head_budget_bytes=budget))
    jckpt.save_registry(str(tmp_path / "reg"), jm)
    tm = tckpt.load_registry(str(tmp_path / "reg"), device="cpu")
    assert sorted(tm) == sorted(jm)
    jd, js = jrouter.LanguageRouter(jm).retrieve_with_scores(
        queries.queries, queries.langs)
    td, ts = trouter.LanguageRouter(tm).retrieve_with_scores(
        queries.queries, queries.langs)
    assert td == jd
    np.testing.assert_allclose(ts, js, rtol=1e-6, atol=CUMSUM_ATOL)
    tckpt.save_registry(str(tmp_path / "reg2"), tm)
    assert sorted(jckpt.load_registry(str(tmp_path / "reg2"))) == sorted(jm)

    # resume: a JAX-written registry resumes in the port; a language whose
    # directory is gone is rebuilt (and checkpointed) with the rest charged
    import shutil

    shutil.rmtree(tmp_path / "reg" / "en")
    tcfg = tconfig.IndexConfig(head_budget_bytes=budget)
    resumed = trouter.build_language_models(corpus, index_cfg=tcfg,
                                            device="cpu",
                                            resume_dir=str(tmp_path / "reg"))
    assert os.path.exists(tmp_path / "reg" / "en" / "meta.json")
    fresh = trouter.build_language_models(corpus, index_cfg=tcfg, device="cpu")
    assert sorted(resumed) == sorted(fresh)
    rd = trouter.LanguageRouter(resumed).retrieve(queries.queries, queries.langs)
    assert rd == td
    jres = jrouter.build_language_models(
        corpus, index_cfg=IndexConfig(head_budget_bytes=budget),
        resume_dir=str(tmp_path / "reg"))
    assert (jres["en"].index.head_size == resumed["en"].index.head_size)


def _dense_cfg():
    return DenseConfig(vocab_size=512, dim=32, depth=2, heads=4, max_len=16,
                       dtype="float32")


def test_dense_model_loads_both_ways(tmp_path):
    from tdr.models.dense import DenseModel as JDense
    from tdr.models.dense import _encode_texts as j_encode
    from tdr.models.encoder import init_encoder as j_init
    from tdr_torch.models import dense as tdense

    cfg = _dense_cfg()
    texts = [f"doc {i} about topic {i % 7} and word{i % 13}" for i in range(40)]
    qs = ["topic 3 word5", "doc 12", "about nothing"]
    model, params = j_init(cfg, seed=3)
    jd = JDense.build(model, params, cfg, texts, [f"d{i}" for i in range(40)])
    jckpt.save_dense_model(str(tmp_path / "j"), jd)
    td = tckpt.load_dense_model(str(tmp_path / "j"), device="cpu")
    assert td.docids == jd.docids and td.flat.n_docs == jd.flat.n_docs
    np.testing.assert_array_equal(
        td.flat.embeddings.float().numpy(),
        np.asarray(jd.flat.embeddings).astype(np.float32))
    want = np.asarray(j_encode(model, params, cfg, qs, 256))
    got = td.encode_queries(qs).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    tckpt.save_dense_model(str(tmp_path / "t"), td)
    jd2 = jckpt.load_dense_model(str(tmp_path / "t"))
    np.testing.assert_allclose(
        np.asarray(j_encode(jd2.model, jd2.params, cfg, qs, 256)), want,
        rtol=1e-6, atol=1e-6)
    td2 = tdense.DenseModel(model=td.model, cfg=cfg, docids=td.docids,
                            flat=td.flat)
    assert td2.retrieve(qs, k=5) == jd.retrieve(qs, k=5)


def test_segmented_checkpoints_and_recovery(tmp_path):
    from tdr.rank.segmented import SegmentedBM25 as JSeg
    from tdr_torch.rank.segmented import SegmentedBM25 as TSeg

    docs, jm = _jmodel(seed=4)
    js = JSeg(main=jm, index_cfg=IndexConfig(**CFG))
    new = _docs(9, 12)
    js.add_documents(new, [f"n{i}" for i in range(12)])
    js.add_documents([docs[2]], ["d2"])             # re-add shadows d2
    js.delete_documents(["d7", "n1"])
    jckpt.save_segmented(str(tmp_path / "seg"), js)
    ts = tckpt.load_segmented(str(tmp_path / "seg"), device="cpu")
    assert isinstance(ts, TSeg) and ts._dead_rows == js._dead_rows
    q = _queries(docs + new, seed=3)
    tv, tr = ts.topk_tokens(q, 10)
    jv, jr = js.topk_tokens(q, 10)
    assert_same_topk(tv, tr, jv, jr, rtol=1e-6, atol=CUMSUM_ATOL)

    tckpt.save_segmented(str(tmp_path / "seg2"), ts)
    js2 = jckpt.load_segmented(str(tmp_path / "seg2"))
    assert js2._dead_rows == ts._dead_rows and js2.docids == ts.docids

    # a save cut between its two renames leaves the old state parked
    os.rename(tmp_path / "seg2", tmp_path / ".seg2.old-123")
    os.makedirs(tmp_path / ".seg3.tmp-99")
    tckpt.recover_segmented_dir(str(tmp_path))
    assert os.path.isdir(tmp_path / "seg2")
    assert not os.path.exists(tmp_path / ".seg3.tmp-99")
    ts3 = tckpt.load_segmented(str(tmp_path / "seg2"), device="cpu")
    np.testing.assert_array_equal(ts3.topk_tokens(q, 10)[1], tr)


def _sharded_world(int8=False):
    from tdr.parallel import build_sharded_index
    from tdr.text import build_vocab, encode_docs, encode_queries

    docs = _docs(6, n=400)
    vocab = build_vocab(docs)
    coo = encode_docs(docs, vocab)
    cfg = dict(CFG, head_dtype="int8" if int8 else "bfloat16",
               doc_pad_multiple=8, nnz_pad_multiple=64)
    js = build_sharded_index(*coo, vocab.size, n_shards=4,
                             index_cfg=IndexConfig(**cfg))
    qids, qw = encode_queries(_queries(docs, seed=2, n=20), vocab, 16)
    return js, qids, qw


@pytest.mark.parametrize("int8", [False, True])
def test_sharded_index_loads_both_ways(int8, tmp_path):
    """``tdr``'s ``save_sharded_index`` -> the port's ``load_sharded_index``
    (shard s on data device s) -> the port's save -> ``tdr``'s load: equal
    top-k at every step, arrays bit for bit."""
    import jax.numpy as jnp
    from tdr.parallel import make_mesh as j_make_mesh
    from tdr.parallel import sharded_score_topk as j_topk
    from tdr_torch.parallel import make_mesh, sharded_score_topk

    js, qids, qw = _sharded_world(int8)
    assert 0 < js.head_size < js.vocab_size
    assert (js.head_scale is not None) == int8
    jckpt.registry.save_sharded_index(str(tmp_path / "j"), js)
    mesh = make_mesh(data=4, devices=["cpu"] * 4)
    ts = tckpt.load_sharded_index(str(tmp_path / "j"), mesh)
    assert all(sh.head_rows.device == torch.device("cpu") for sh in ts.shards)
    assert ts.shards[0].head_rows.dtype == (torch.int8 if int8
                                            else torch.bfloat16)
    jv, jr = j_topk(j_make_mesh(data=4), js, jnp.asarray(qids),
                    jnp.asarray(qw), 10)
    tv, tr = sharded_score_topk(mesh, ts, torch.from_numpy(qids),
                                torch.from_numpy(qw), 10)
    assert_same_topk(tv, tr, jv, jr, rtol=1e-6, atol=CUMSUM_ATOL)

    tckpt.save_sharded_index(str(tmp_path / "t"), ts)
    js2 = jckpt.registry.load_sharded_index(str(tmp_path / "t"))
    for name in ("indptr", "postings_doc", "postings_w", "head_rows",
                 "df_local", "doc_len", "head_slot", "idf", "n_valid"):
        np.testing.assert_array_equal(np.asarray(getattr(js2, name)),
                                      np.asarray(getattr(js, name)))
    jv2, jr2 = j_topk(j_make_mesh(data=4), js2, jnp.asarray(qids),
                      jnp.asarray(qw), 10)
    np.testing.assert_array_equal(np.asarray(jv2), np.asarray(jv))
    np.testing.assert_array_equal(np.asarray(jr2), np.asarray(jr))
    ts2 = tckpt.load_sharded_index(str(tmp_path / "t"), device="cpu")
    tv2, tr2 = sharded_score_topk(mesh, ts2, torch.from_numpy(qids),
                                  torch.from_numpy(qw), 10)
    assert torch.equal(tv2, tv) and torch.equal(tr2, tr)


@pytest.mark.parametrize("s", [0, 2])
def test_build_index_global_overrides(s):
    """A shard built with the corpus-global statistics (``head_slot``,
    ``idf``, ``avgdl``, ``tail_pmax``) and the shared pads scores its docs
    as the single-device index does: its head columns are the single
    index's (bf16 values equal), its tail postings the single index's rows
    of its docs; and the port's shard equals ``tdr``'s array for array."""
    from tdr.index import build_index as j_build_index
    from tdr.text import build_vocab, encode_docs
    from tdr_torch.index.build import build_index as t_build_index

    docs = _docs(8, n=300)
    vocab = build_vocab(docs)
    doc_ids, term_ids, tfs, doc_lens = encode_docs(docs, vocab)
    tcfg = tconfig.IndexConfig(**CFG)
    single = t_build_index(doc_ids, term_ids, tfs, doc_lens, vocab.size,
                           index_cfg=tcfg, df_host=vocab.df, device="cpu")
    assert 0 < single.head_size < single.vocab_size
    lo, hi = 75 * s, 75 * (s + 1)
    sel = (doc_ids >= lo) & (doc_ids < hi)
    kw = dict(head_size=single.head_size, idf=single.stats.idf.numpy(),
              head_slot=single.head_slot.numpy(),
              avgdl=float(single.stats.avgdl), n_docs_pad=128, nnz_pad=4096,
              tail_pmax=single.tail_pmax)
    args = (doc_ids[sel] - lo, term_ids[sel], tfs[sel], doc_lens[lo:hi],
            vocab.size)
    shard = t_build_index(*args, index_cfg=tcfg, device="cpu", **kw)
    assert (shard.n_docs_pad, shard.tail_pmax) == (128, single.tail_pmax)
    assert shard.postings_doc.shape[0] >= 4096
    np.testing.assert_array_equal(
        shard.head_rows[:, :hi - lo].float().numpy(),
        single.head_rows[:, lo:hi].float().numpy())
    assert not shard.head_rows[:, hi - lo:].any()
    # every tail term's postings: the single index's, restricted to the slice
    for t in np.nonzero(single.head_slot.numpy() < 0)[0][:200]:
        a, b = int(single.indptr[t]), int(single.indptr[t + 1])
        d = single.postings_doc[a:b].numpy()
        keep = (d >= lo) & (d < hi)
        a2, b2 = int(shard.indptr[t]), int(shard.indptr[t + 1])
        np.testing.assert_array_equal(shard.postings_doc[a2:b2].numpy(),
                                      d[keep] - lo)
        np.testing.assert_array_equal(shard.postings_w[a2:b2].numpy(),
                                      single.postings_w[a:b].numpy()[keep])
    jshard = j_build_index(*args, index_cfg=IndexConfig(**CFG), **kw)
    for name in ("indptr", "postings_doc", "head_slot"):
        np.testing.assert_array_equal(getattr(shard, name).numpy(),
                                      np.asarray(getattr(jshard, name)))
    np.testing.assert_array_equal(
        shard.head_rows.view(torch.int16).numpy(),
        np.asarray(jshard.head_rows).view(np.int16))
    np.testing.assert_allclose(shard.postings_w.numpy(),
                               np.asarray(jshard.postings_w), rtol=1e-6)
