"""The frozen generator gives the port's generator's corpus and queries,
byte for byte, for the same spec."""

import pytest

from tdrbench.harness import synthetic as frozen


@pytest.mark.parametrize("kw", [
    dict(n_docs=3000, n_queries=400, seed=2**31 + 5, hard=True),
    dict(n_docs=1200, n_queries=100, seed=7),
    dict(n_docs=800, n_queries=50, seed=3, hard=True, sentences_per_doc=4),
    dict(n_docs=500, n_queries=50, seed=11, ref_proportions=False,
         langs=("en", "ko"), vocab_per_lang=300),
])
def test_same_corpus_as_the_port(kw):
    from tdr_torch.data import synthetic as port

    c1, q1 = frozen.synthetic_corpus(frozen.SyntheticSpec(**kw))
    c2, q2 = port.synthetic_corpus(port.SyntheticSpec(**kw))
    assert (c1.docids, c1.texts, c1.langs) == (c2.docids, c2.texts, c2.langs)
    assert (q1.query_ids, q1.queries, q1.langs, q1.positive_docs) == \
        (q2.query_ids, q2.queries, q2.langs, q2.positive_docs)
