"""The whole slice on CPU: ``build_language_models`` + ``LanguageRouter``
in the JAX package and in the port, on the same small hard-mode corpus.

The head budget is small enough to leave tails, so both kernel plain
versions' paths run (tail compaction everywhere; the fused head needs
65,536 docs and is covered by test_torch_kernels.py).  Queries go through
the buckets 1 and 8 and the full batch.  Docid lists must be equal, scores
within rtol 1e-5 / atol 1e-5; a rank may differ only where JAX's two
scores there are within that tolerance of each other.
"""

import fcntl
import os
import tempfile

import numpy as np
import pytest

from tests.torch_threads import torch

from tdr.data import SyntheticSpec, synthetic_corpus  # noqa: E402
from tdr.rank import router as jrouter  # noqa: E402
from tdr.utils.config import IndexConfig  # noqa: E402
from tdr_torch.ops import cuda_build  # noqa: E402
from tdr_torch.rank import router as trouter  # noqa: E402
from tdr_torch.utils import config as tconfig  # noqa: E402

HEAD_BUDGET = 3 << 20
_SLICE = {}


def _native_built_once():
    """Build the port's native tokenizer under a file lock: test workers
    must not run its lazy `make` at the same time."""
    path = os.path.join(tempfile.gettempdir(), "tdr_torch_native.lock")
    with open(path, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        from tdr_torch import native

        assert native.available()


def _slice():
    if not _SLICE:
        _native_built_once()
        corpus, queries = synthetic_corpus(SyntheticSpec(
            n_docs=1500, n_queries=150, seed=21, hard=True))
        jm = jrouter.build_language_models(
            corpus, index_cfg=IndexConfig(head_budget_bytes=HEAD_BUDGET))
        tm = trouter.build_language_models(
            corpus, index_cfg=tconfig.IndexConfig(head_budget_bytes=HEAD_BUDGET),
            device="cpu")
        _SLICE.update(corpus=corpus, queries=queries, jm=jm, tm=tm)
    return _SLICE


def _same(tdocs, tscores, jdocs, jscores, rtol=1e-5, atol=1e-5):
    assert len(tdocs) == len(jdocs)
    np.testing.assert_allclose(tscores, jscores, rtol=rtol, atol=atol)
    for q, (a, b) in enumerate(zip(tdocs, jdocs)):
        assert len(a) == len(b), f"query {q}"
        for r, (x, y) in enumerate(zip(a, b)):
            if x != y:
                near = np.isclose(jscores[q], jscores[q, r], rtol=rtol, atol=atol)
                assert near.sum() >= 2, f"query {q} rank {r}: {x} != {y}"


def test_slice_builds_same_indexes():
    s = _slice()
    assert sorted(s["jm"]) == sorted(s["tm"])
    tails = 0
    for lang, jmod in s["jm"].items():
        j, t = jmod.index, s["tm"][lang].index
        for f in ("n_docs", "n_docs_pad", "vocab_size", "tail_pmax", "head_size"):
            assert getattr(j, f) == getattr(t, f), (lang, f)
        np.testing.assert_array_equal(t.indptr.numpy(), np.asarray(j.indptr))
        np.testing.assert_array_equal(t.head_slot.numpy(), np.asarray(j.head_slot))
        assert s["jm"][lang].vocab.term_to_id == s["tm"][lang].vocab.term_to_id
        tails += t.head_size < t.vocab_size
    assert tails >= 3, "the budget must leave tails"


@pytest.mark.parametrize("bucket", ["full", "one", "eight"])
def test_slice_retrieve_matches_jax(bucket, monkeypatch):
    monkeypatch.setenv("TDR_PALLAS_HEAD", "0")
    s = _slice()
    qs, langs = s["queries"].queries, s["queries"].langs
    if bucket == "one":
        sel = [0]
    elif bucket == "eight":
        first = langs[0]
        sel = [i for i, l in enumerate(langs) if l == first][:8]
    else:
        sel = list(range(len(qs)))
    q = [qs[i] for i in sel]
    lq = [langs[i] for i in sel]
    jr = jrouter.LanguageRouter(s["jm"], query_batch=32)
    tr = trouter.LanguageRouter(s["tm"], query_batch=32)
    jdocs, jscores = jr.retrieve_with_scores(q, lq, k=10)
    tdocs, tscores = tr.retrieve_with_scores(q, lq, k=10)
    _same(tdocs, tscores, jdocs, jscores)
    assert tr.retrieve(q, lq, k=10) == tdocs
    if bucket == "full":
        from tdr.eval import recall_at_k
        pos = s["queries"].positive_docs
        assert recall_at_k(tdocs, pos, 10) == recall_at_k(jdocs, pos, 10)


def test_slice_counts_no_launch_on_cpu():
    s = _slice()
    cuda_build.reset_launches()
    trouter.LanguageRouter(s["tm"], query_batch=32).retrieve(
        s["queries"].queries[:40], s["queries"].langs[:40])
    assert cuda_build.launches == {"tail_compact": 0, "fused_head": 0,
                                   "fused_head_f32": 0, "fused_flat": 0,
                                   "fused_flat_f32": 0, "head_scores": 0,
                                   "layer_norm_fwd": 0, "layer_norm_bwd": 0,
                                   "attention_fwd": 0, "attention_bwd": 0,
                                   "adamw": 0}


def test_engine_choice_follows_jax_rules():
    s = _slice()
    m = s["tm"]["en"]
    assert m.head_engine(1, 10) == "gather"
    assert m.head_engine(8, 10) == "gather"
    assert m.head_engine(9, 10) == "matmul"      # under 65,536 docs


@pytest.mark.parametrize("model", ["BM25Model", "TfidfCosineModel"])
def test_models_match_jax(model):
    from tdr.models import sparse as jsparse
    from tdr.text import build_vocab, encode_docs
    from tdr_torch.models import sparse as tsparse

    rng = np.random.RandomState(2)
    docs = [[f"w{rng.randint(300)}" for _ in range(rng.randint(3, 40))]
            for _ in range(200)]
    queries = [[f"w{rng.randint(300)}" for _ in range(rng.randint(1, 6))]
               for _ in range(12)]
    vocab = build_vocab(docs)
    coo = encode_docs(docs, vocab)
    cfg = dict(head_budget_bytes=1 << 14, head_dtype="float32")
    ids = [f"d{i}" for i in range(len(docs))]
    jm = getattr(jsparse, model).from_coo(vocab, coo, ids,
                                          index_cfg=IndexConfig(**cfg))
    tm = getattr(tsparse, model).from_coo(vocab, coo, ids,
                                          index_cfg=tconfig.IndexConfig(**cfg),
                                          device="cpu")
    assert tm.index.head_size < tm.index.vocab_size
    for q in (queries, queries[:1]):                 # matmul and gather heads
        jv, jr = jm.topk_tokens(q, 10)
        tv, tr = tm.topk_tokens(q, 10)
        _same([list(r) for r in tr], tv, [list(r) for r in jr], jv)


@pytest.mark.parametrize("knobs", [dict(prf=True), dict(spell_correct=True),
                                   dict(prf=True, spell_correct=True)])
def test_unported_knobs_raise(knobs):
    """Once "not ported yet": PRF and spell repair now run through the
    router and match tdr on the slice.  With PRF, a query whose first pass
    holds a near-tie (within 1e-5) at the edge of its feedback docs may
    mine other docs in the two packages (their head products sum in other
    orders); such queries are found from both first passes, must be rare,
    and are left out of the comparison."""
    import dataclasses

    s = _slice()
    qs, langs = s["queries"].queries, s["queries"].langs
    skip = set()
    if knobs.get("prf"):
        F = s["tm"]["en"].prf_docs
        first = dict(knobs, prf=False)
        jd1, js1 = jrouter.LanguageRouter(
            {l: dataclasses.replace(m, **first) for l, m in s["jm"].items()},
            query_batch=32).retrieve_with_scores(qs, langs, k=F + 1)
        td1, _ = trouter.LanguageRouter(
            {l: dataclasses.replace(m, **first) for l, m in s["tm"].items()},
            query_batch=32).retrieve_with_scores(qs, langs, k=F + 1)
        for q in range(len(qs)):
            if set(jd1[q][:F]) != set(td1[q][:F]):
                assert np.isclose(js1[q, F - 1], js1[q, F], rtol=1e-5,
                                  atol=1e-5), f"query {q}: feedback differs"
                skip.add(q)
        assert len(skip) <= len(qs) // 50
    keep = [q for q in range(len(qs)) if q not in skip]
    jr = jrouter.LanguageRouter({l: dataclasses.replace(m, **knobs)
                                 for l, m in s["jm"].items()}, query_batch=32)
    tr = trouter.LanguageRouter({l: dataclasses.replace(m, **knobs)
                                 for l, m in s["tm"].items()}, query_batch=32)
    jdocs, jscores = jr.retrieve_with_scores(qs, langs, k=10)
    tdocs, tscores = tr.retrieve_with_scores(qs, langs, k=10)
    _same([tdocs[q] for q in keep], tscores[keep],
          [jdocs[q] for q in keep], jscores[keep])
    plain = trouter.LanguageRouter(s["tm"], query_batch=32).retrieve(qs, langs)
    changed = sum(a != b for a, b in zip(tdocs, plain))
    assert changed > len(qs) // 10, "the knob must change some results"


def test_build_language_models_needs_a_device(monkeypatch):
    from tdr_torch.data.loaders import Corpus

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    corpus = Corpus(docids=["d0", "d1"], texts=["a b c", "c d e"],
                    langs=["en", "en"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trouter.build_language_models(corpus)


def test_waterfill_copy_matches_jax():
    rng = np.random.RandomState(0)
    for _ in range(20):
        stats = {f"l{i}": (int(rng.randint(1, 1 << 30)), float(rng.randint(1, 9)))
                 for i in range(rng.randint(1, 8))}
        total = int(rng.randint(0, 1 << 31))
        assert trouter._waterfill_head_budget(total, stats) == \
            jrouter._waterfill_head_budget(total, stats)
