"""The port's hard-negative mining and pseudo-queries against the JAX
package, on CPU, in ``tests/test_mining.py``'s small world (400 hard-mode
docs in en and fr, 40 queries, seed 11), each package mining through its
own ``LanguageRouter``.

``tdr_torch.train.mining`` is a copy of ``tdr/train/mining.py`` (no JAX), so
pseudo-queries and concatenations are equal outright; mined negatives are
equal because the two routers return the same top-k lists here (their
scores agree within 1e-5 and no near-tie sits inside a mined window).  A
mined set then feeds the port's trainer.
"""

import dataclasses
import fcntl
import os
import tempfile

import numpy as np
import pytest

from tests.torch_threads import torch

from tdr.data import SyntheticSpec, synthetic_corpus  # noqa: E402
from tdr.rank import LanguageRouter as JRouter  # noqa: E402
from tdr.rank import build_language_models as jbuild  # noqa: E402
from tdr.train import mining as jmining  # noqa: E402
from tdr_torch.data.loaders import Corpus, QuerySet  # noqa: E402
from tdr_torch.rank import LanguageRouter as TRouter  # noqa: E402
from tdr_torch.rank import build_language_models as tbuild  # noqa: E402
from tdr_torch.train import mining as tmining  # noqa: E402
from tdr_torch.train import train_dense_retriever  # noqa: E402
from tdr_torch.utils.config import DenseConfig  # noqa: E402

_WORLD = {}


def _native_built_once():
    """Build the port's native tokenizer under a file lock: test workers
    must not run its lazy `make` at the same time."""
    path = os.path.join(tempfile.gettempdir(), "tdr_torch_native.lock")
    with open(path, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        from tdr_torch import native

        assert native.available()


def _world():
    if not _WORLD:
        _native_built_once()
        corpus, queries = synthetic_corpus(SyntheticSpec(
            n_docs=400, n_queries=40, seed=11, hard=True,
            ref_proportions=False, langs=("en", "fr")))
        _WORLD.update(
            corpus=corpus, queries=queries,
            jr=JRouter(jbuild(corpus), query_batch=64),
            tr=TRouter(tbuild(corpus, device="cpu"), query_batch=64))
    return _WORLD


def _port_qs(qs):
    return QuerySet(qs.query_ids, qs.queries, qs.langs, qs.positive_docs,
                    qs.negative_docs)


@pytest.mark.parametrize("n_neg,depth,skip_top", [(2, 10, 0), (3, 20, 1),
                                                  (1, 5, 0)])
def test_mined_negatives_match_jax(n_neg, depth, skip_top):
    w = _world()
    kw = dict(n_neg=n_neg, depth=depth, skip_top=skip_top, seed=4,
              fallback_docids=w["corpus"].docids)
    j = jmining.mine_hard_negatives(w["jr"], w["queries"], **kw)
    t = tmining.mine_hard_negatives(w["tr"], _port_qs(w["queries"]), **kw)
    assert isinstance(t, QuerySet)
    assert t.negative_docs == j.negative_docs
    assert all(len(n) == n_neg for n in t.negative_docs)
    assert t.queries == j.queries and t.positive_docs == j.positive_docs


def test_exhausted_pool_pads_like_jax():
    """A depth-2 window and a 3-doc fallback pool for 6 negatives: the
    padding draws from numpy's RandomState in both packages."""
    w = _world()
    pool = w["corpus"].docids[:3]
    kw = dict(n_neg=6, depth=2, seed=9, fallback_docids=pool)
    j = jmining.mine_hard_negatives(w["jr"], w["queries"], **kw)
    t = tmining.mine_hard_negatives(w["tr"], _port_qs(w["queries"]), **kw)
    assert t.negative_docs == j.negative_docs
    assert any(len(n) < 6 for n in t.negative_docs)
    with pytest.raises(ValueError, match="positive_docs"):
        tmining.mine_hard_negatives(w["tr"], dataclasses.replace(
            _port_qs(w["queries"]), positive_docs=None))


@pytest.mark.parametrize("n,seed,lo,hi", [(50, 3, 3, 6), (30, 8, 2, 4)])
def test_pseudo_queries_match_jax(n, seed, lo, hi):
    corpus = _world()["corpus"]
    j = jmining.make_pseudo_queries(corpus, n, terms_lo=lo, terms_hi=hi,
                                    seed=seed)
    t = tmining.make_pseudo_queries(corpus, n, terms_lo=lo, terms_hi=hi,
                                    seed=seed)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    with pytest.raises(ValueError, match="terms_lo"):
        tmining.make_pseudo_queries(Corpus(["a"], ["x y"], ["en"]), 2)


def test_concat_querysets_matches_jax():
    w = _world()
    pj = jmining.make_pseudo_queries(w["corpus"], 10, seed=1)
    pt = tmining.make_pseudo_queries(w["corpus"], 10, seed=1)
    mj = jmining.mine_hard_negatives(w["jr"], pj, n_neg=1)
    mt = tmining.mine_hard_negatives(w["tr"], pt, n_neg=1)
    for parts_j, parts_t in (([w["queries"], pj], [_port_qs(w["queries"]), pt]),
                             ([mj, mj], [mt, mt])):
        j = jmining.concat_querysets(parts_j)
        t = tmining.concat_querysets(parts_t)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    with pytest.raises(ValueError):
        tmining.concat_querysets([])


def test_mined_set_feeds_the_trainer():
    """The bench's flow at a tiny width: pseudo-queries + the labelled ones,
    negatives mined through the port's router, three epochs."""
    w = _world()
    corpus = w["corpus"]
    pqs = tmining.make_pseudo_queries(corpus, 160, seed=11)
    mined = tmining.mine_hard_negatives(
        w["tr"], tmining.concat_querysets([_port_qs(w["queries"]), pqs]),
        n_neg=2, depth=20, fallback_docids=corpus.docids, seed=11)
    cfg = DenseConfig(vocab_size=500, dim=32, depth=1, heads=2, max_len=32)
    model, state, last = train_dense_retriever(
        corpus, mined, cfg, epochs=3, batch_size=20, n_neg=2, lr=1e-3,
        device="cpu")
    assert state.step == 3 * (200 // 20)
    curve = last["loss_curve"]
    assert len(curve) == 3 and np.isfinite(curve).all()
    assert curve[-1] < curve[0]
