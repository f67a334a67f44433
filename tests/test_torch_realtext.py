"""The port's copy of the real-text eval set (``tdr/data/realtext.py``)
and its run through build and router, against ``tdr`` on CPU.

The data must be equal item for item.  Through ``build_language_models``
and ``LanguageRouter`` (k = 10, batches of 16) at the "best" and "porter"
pipelines the port's lists equal ``tdr``'s but for near-ties of their
scores (rtol 1e-5), and the recalls are equal; at "best" they hold
``tests/test_realtext_eval.py``'s floors (recall@10 0.95, recall@1 0.90).
"""

import numpy as np
import pytest

from tests.torch_threads import torch

from tdr.data import realtext as jrt  # noqa: E402
from tdr_torch.data import realtext as trt  # noqa: E402


def test_realtext_data_equals_jax_package():
    assert trt.LANGS == jrt.LANGS
    assert trt.REAL_DOCS == jrt.REAL_DOCS
    assert trt.REAL_QUERIES == jrt.REAL_QUERIES
    assert trt.real_eval_corpus() == jrt.real_eval_corpus()
    assert sum(len(v) for v in trt.REAL_DOCS.values()) == 140
    assert sum(len(v) for v in trt.REAL_QUERIES.values()) == 70


def _same_lists(a_docs, a_scores, b_docs, b_scores, rtol=1e-5):
    """Equal lists but where two docs' scores tie within ``rtol``."""
    for da, sa, db, sb in zip(a_docs, a_scores, b_docs, b_scores):
        assert len(da) == len(db)
        np.testing.assert_allclose(sa, sb, rtol=rtol, atol=1e-6)
        for i, (x, y) in enumerate(zip(da, db)):
            if x != y:
                near = [j for j in range(len(sb))
                        if abs(sb[j] - sb[i]) <= rtol * abs(sb[i]) + 1e-6]
                assert x in [db[j] for j in near], (da, db)


@pytest.mark.parametrize("pipeline", ["best", "porter"])
def test_realtext_through_build_and_router_matches_jax(pipeline):
    from tdr.data.loaders import Corpus as JCorpus
    from tdr.eval import recall_at_k
    from tdr.rank import LanguageRouter as JRouter
    from tdr.rank import build_language_models as jbuild
    from tdr.text import Preprocessor as JPre
    from tdr_torch.data.loaders import Corpus
    from tdr_torch.rank import LanguageRouter, build_language_models
    from tdr_torch.text import Preprocessor

    docs, docids, dlangs, queries, qlangs, positives = trt.real_eval_corpus()
    jmodels = jbuild(JCorpus(docids, docs, dlangs), preprocessor=JPre(pipeline))
    jr = JRouter(jmodels, preprocessor=JPre(pipeline), query_batch=16)
    jd, js = jr.retrieve_with_scores(queries, qlangs, k=10)
    tmodels = build_language_models(Corpus(docids, docs, dlangs),
                                    preprocessor=Preprocessor(pipeline),
                                    device="cpu")
    tr = LanguageRouter(tmodels, preprocessor=Preprocessor(pipeline),
                        query_batch=16)
    td, ts = tr.retrieve_with_scores(queries, qlangs, k=10)
    _same_lists(td, [np.asarray(s) for s in ts], jd,
                [np.asarray(s) for s in js])
    r10 = recall_at_k(td, positives, 10)
    r1 = recall_at_k([r[:1] for r in td], positives, 1)
    assert r10 == recall_at_k(jd, positives, 10)
    assert r1 == recall_at_k([r[:1] for r in jd], positives, 1)
    if pipeline == "best":
        assert r10 >= 0.95 and r1 >= 0.90, (r10, r1)
