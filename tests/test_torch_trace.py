"""The port's spans and counters (``tdr_torch.utils.trace``): they exist only
while a profiler records, the query and train paths open the spans their
readers expect (one host op a span, one ``tdr_torch.sync.*`` span a host
wait), and recording them changes no answer."""

import collections
import fcntl
import os
import tempfile

import numpy as np

from tests.torch_threads import torch

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from tdr_torch.data.synthetic import SyntheticSpec, synthetic_corpus  # noqa: E402
from tdr_torch.rank import router as trouter  # noqa: E402
from tdr_torch.utils import config as tconfig  # noqa: E402
from tdr_torch.utils import trace  # noqa: E402

LANGS = ("de", "en", "ko")
BATCH = 16
_SLICE = {}


def _native_built_once():
    """Build the port's native tokenizer under a file lock: test workers
    must not run its lazy `make` at the same time."""
    path = os.path.join(tempfile.gettempdir(), "tdr_torch_native.lock")
    with open(path, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        from tdr_torch import native

        assert native.available()


def _router():
    """Three languages with tails; a batch of 16, so en's 55 queries make
    three full batches and one padded to 8, de's 3 and ko's 2 one each."""
    if not _SLICE:
        _native_built_once()
        corpus, queries = synthetic_corpus(SyntheticSpec(
            n_docs=600, n_queries=60, seed=3, hard=True, langs=LANGS))
        models = trouter.build_language_models(
            corpus, index_cfg=tconfig.IndexConfig(head_budget_bytes=1 << 20),
            device="cpu")
        _SLICE.update(router=trouter.LanguageRouter(models, query_batch=BATCH),
                      queries=queries)
    return _SLICE["router"], _SLICE["queries"]


def _batches(router, langs):
    """(real rows, padded rows) of each batch the router makes."""
    out = []
    for lang, n in sorted(collections.Counter(langs).items()):
        for s in range(0, n, BATCH):
            m = min(BATCH, n - s)
            out.append((m, router._pad_target(m)))
    return out


def _spans(prof):
    return collections.Counter(e.name for e in prof.events()
                               if e.name.startswith("tdr_torch."))


def test_no_profiler_no_span_no_count():
    router, q = _router()
    assert not torch.autograd._profiler_enabled()
    a, b = trace.annotate("tdr_torch.x"), trace.annotate("tdr_torch.y")
    assert a is b
    before = dict(trace.counters)
    router.retrieve_with_scores(q.queries, q.langs, k=10)
    trace.count("router.rows_real", 5)
    assert trace.counters == before


def test_a_call_records_its_spans_and_counters():
    router, q = _router()
    batches = _batches(router, q.langs)
    assert any(real < padded for real, padded in batches)
    trace.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        router.retrieve_with_scores(q.queries, q.langs, k=10)
    n = len(batches)
    assert _spans(prof) == {
        "tdr_torch.router.retrieve": 1, "tdr_torch.router.group": 1,
        "tdr_torch.router.tokenize": len(LANGS),
        "tdr_torch.sparse.encode": n, "tdr_torch.sparse.score": n,
        "tdr_torch.router.map_docids": n,
        # one span a host wait: each batch copies its term ids and weights
        # in apart, then reads its overflow flag; the call reads its
        # results back once
        "tdr_torch.sync.queries_h2d": 2 * n, "tdr_torch.sync.overflow": n,
        "tdr_torch.sync.results": 1}
    assert trace.counters == {
        "router.rows_real": len(q.queries),
        "router.rows_padded": sum(p for _, p in batches)}
    trace.reset_counters()
    assert trace.counters == {}


def test_retrieve_opens_the_same_call_span():
    router, q = _router()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        router.retrieve(q.queries[:3], q.langs[:3], k=10)
    spans = _spans(prof)
    assert spans["tdr_torch.router.retrieve"] == 1
    assert spans["tdr_torch.sync.results"] == 1


def test_recording_changes_no_answer():
    router, q = _router()
    docs, scores = router.retrieve_with_scores(q.queries, q.langs, k=10)
    with profile(activities=[ProfilerActivity.CPU]):
        docs_p, scores_p = router.retrieve_with_scores(q.queries, q.langs,
                                                       k=10)
    assert docs_p == docs
    np.testing.assert_array_equal(scores_p.view(np.uint32),
                                  scores.view(np.uint32))


def test_a_train_step_records_its_spans():
    from tdr_torch.train import create_train_state, make_train_step
    from tdr_torch.utils.config import DenseConfig

    cfg = DenseConfig(vocab_size=500, dim=32, depth=1, heads=2, max_len=16)
    state = create_train_state(cfg, lr=1e-3, seed=0, device="cpu")
    rng = np.random.RandomState(0)
    ids = lambda: rng.randint(1, 500, (4, 16)).astype(np.int32)  # noqa: E731
    batch = {"q_ids": ids(), "q_mask": np.ones((4, 16), np.int32),
             "p_ids": ids(), "p_mask": np.ones((4, 16), np.int32)}
    step = make_train_step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch)
    assert _spans(prof) == {
        "tdr_torch.train.forward": 1, "tdr_torch.train.backward": 1,
        # zero_grad before the backward, the update after it
        "tdr_torch.train.optimizer": 2,
        # ids and mask, each copied in apart
        "tdr_torch.sync.batch_h2d": 2}
