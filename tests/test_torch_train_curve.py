"""The JAX bench's training flow (bench.py:417-471) in both packages on the
CPU, at the bench's own scale: 100,000 en docs of 6 sentences (seed 7), the
200 dev queries and 4000 pseudo-queries (seed 11), 2 negatives each mined
through the port's BM25 router (equal to ``tdr``'s: tests/test_torch_mining.py),
3 epochs of 50 at ``DenseConfig(vocab_size=4000, dim=64, depth=2, heads=4,
max_len=32)`` and lr 1e-3.

The end-of-epoch losses depend on the random init far more than on the
package: from flax's seed-0 init carried across, the port's curve stays
within 0.05 of ``tdr``'s at every epoch (bf16: the two sum in other orders,
and 252 steps compound it); from each package's own seeds 0 and 1 the
third epoch's loss lands anywhere between about 2.2 and 3.3.  Run with
``-s`` to print the curves.
"""

import flax
import jax
import numpy as np

from tests.torch_threads import torch

from tdr.train import contrastive as jc  # noqa: E402
from tdr.utils.config import DenseConfig as JDenseConfig  # noqa: E402
from tdr_torch.data import SyntheticSpec, synthetic_corpus  # noqa: E402
from tdr_torch.data.loaders import QuerySet  # noqa: E402
from tdr_torch.rank import LanguageRouter, build_language_models  # noqa: E402
from tdr_torch.train import (concat_querysets, make_pseudo_queries,  # noqa: E402
                             mine_hard_negatives)
from tdr_torch.train import contrastive as tc  # noqa: E402
from tdr_torch.utils.config import DenseConfig  # noqa: E402

CFG = dict(vocab_size=4000, dim=64, depth=2, heads=4, max_len=32)
RUN = dict(epochs=3, batch_size=50, n_neg=2, lr=1e-3)


def test_bench_loss_curve_tracks_jax_from_one_init(monkeypatch):
    corpus, queries = synthetic_corpus(SyntheticSpec(
        n_docs=100_000, n_queries=700, seed=7, hard=True,
        ref_proportions=False, langs=("en",), sentences_per_doc=6))
    router = LanguageRouter(build_language_models(corpus, device="cpu"),
                            query_batch=256)
    dev = QuerySet(queries.query_ids[:200], queries.queries[:200],
                   queries.langs[:200], queries.positive_docs[:200])
    mined = mine_hard_negatives(
        router, concat_querysets([dev, make_pseudo_queries(corpus, 4000,
                                                           seed=11)]),
        n_neg=2, depth=20, fallback_docids=corpus.docids, seed=11)
    del router

    curves = {}
    for seed in (0, 1):
        curves[f"tdr seed {seed}"] = jc.train_dense_retriever(
            corpus, mined, JDenseConfig(**CFG), seed=seed, **RUN)[2]
        curves[f"port seed {seed}"] = tc.train_dense_retriever(
            corpus, mined, DenseConfig(**CFG), seed=seed, device="cpu",
            **RUN)[2]
    _, state, tx = jc.create_train_state(JDenseConfig(**CFG), lr=RUN["lr"])
    carried = tc.train_state_from_optax(
        *(jax.tree_util.tree_map(np.asarray, flax.linen.meta.unbox(t))
          for t in (state.params, state.opt_state)),
        0, DenseConfig(**CFG), RUN["lr"], device="cpu")
    monkeypatch.setattr(tc, "create_train_state",
                        lambda cfg, lr, seed, device: carried)
    curves["port from tdr's seed-0 init"] = tc.train_dense_retriever(
        corpus, mined, DenseConfig(**CFG), device="cpu", **RUN)[2]
    for name, last in curves.items():
        print(f"{name}: loss curve {last['loss_curve']}")
        assert len(last["loss_curve"]) == 3
        assert np.isfinite(last["loss_curve"]).all()
        assert last["loss_curve"][-1] < last["loss_curve"][0], name
    np.testing.assert_allclose(curves["port from tdr's seed-0 init"]
                               ["loss_curve"],
                               curves["tdr seed 0"]["loss_curve"], atol=0.05)
    assert len(mined.queries) == 4200
