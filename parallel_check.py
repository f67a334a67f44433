#!/usr/bin/env python3
"""Phase 12 of ``chip_smoke.py`` (the parallel serving layer) and phase
13d (the sharded train step, and ``train --mesh 2x2`` through the CLI) on
their own, over every visible CUDA device.

    python3 parallel_check.py               # phases 12 and 13d
    python3 parallel_check.py --train-only  # 13d alone

It builds what phase 12 reads with ``chip_smoke.py``'s own functions (the
kernels; phase 2's 268,022-doc corpus, BM25 models and router lists;
phase 7's dense index and encoded queries; 8e's cascade) and then runs
``chip_smoke.parallel_phase``: the 4-way mesh over ``cuda:(i %
device_count)``.  On one card that is ``chip_smoke.py``'s phase 12; on
four cards every shard lies on its own card, the pipelined cascade's
stage 2 on a second card, and the collectives copy between cards, so each
kernel launches on a card other than the current one.  Then 13d: the
sharded train step at ``DenseConfig()`` width over ``make_mesh(data=2,
model=2)`` of the same devices (one shard a card on four) against the
single-device step, on 22 batches of 50 pseudo-queries of phase 2's
corpus, and the CLI's ``train --mesh 2x2`` (sharded when more than one
card is visible).  ``--train-only`` runs 13d alone: after a change to
the sharded train step, a four-card call need not pay for phase 12.
Exits non-zero on
any failed check; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--train-only", action="store_true",
                    help="run phase 13d alone, not phase 12")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("parallel_check FAILED: no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from tdr_torch.data import SyntheticSpec, synthetic_corpus
    from tdr_torch.ops import cuda_build
    from tdr_torch.utils.config import DenseConfig

    t0 = time.perf_counter()
    card = cs.card_line()
    cs.say(card)
    cs.say(f"{torch.cuda.device_count()} CUDA device(s): "
           f"{[torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]}")
    cuda_build.build(force=True)
    corpus, queries = synthetic_corpus(SyntheticSpec(
        n_docs=cs.N_DOCS, n_queries=2000, seed=42, hard=True))
    cfg = DenseConfig()
    if not args.train_only:
        parallel_serving(cs, corpus, queries, cfg, card, t0)
    train_phase(cs, corpus, cfg)
    cs.say(f"total {time.perf_counter() - t0:.1f} s")
    cs.say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def parallel_serving(cs, corpus, queries, cfg, card, t0) -> None:
    """Phase 12 on what it reads, built here."""
    from tdr_torch.models.dense import DenseModel
    from tdr_torch.models.encoder import init_encoder
    from tdr_torch.rank import LanguageRouter, build_language_models
    from tdr_torch.utils.config import IndexConfig

    models = build_language_models(
        corpus, index_cfg=IndexConfig(head_budget_bytes=cs.HEAD_BUDGET),
        device=cs.DEVICE)
    router = LanguageRouter(models, query_batch=256)
    full_docs, full_scores = router.retrieve_with_scores(
        queries.queries, queries.langs, k=10)

    def batch(lang, n, start=0):
        qs = [q for q, l in zip(queries.queries, queries.langs)
              if l == lang][start:start + n]
        toks = router._tokenize(qs, range(len(qs)), lang)
        toks = toks + [[]] * (n - len(toks))
        return models[lang].encode_query_tokens(toks)

    dense = DenseModel.build(init_encoder(cfg, seed=0, device=cs.DEVICE), cfg,
                             corpus.texts, corpus.docids, batch=256)
    q_enc = dense.encode_queries(queries.queries)
    bench_emb, bench_q = cs.bench_embeddings()
    _, cascade = cs.cascade_phase(3)
    cs.say(f"set-up {time.perf_counter() - t0:.1f} s")
    paths = cs.parallel_phase(models, queries, full_docs, full_scores, batch,
                              dense.flat, q_enc, bench_emb, bench_q, cascade,
                              card, 5)
    cs.say(json.dumps({"launches_by_path": paths}))


def train_phase(cs, corpus, cfg) -> None:
    """13d: the sharded step against the unsharded one, then the CLI's
    ``train --mesh 2x2``."""
    import itertools
    import shutil
    import tempfile

    from tdr_torch.train.contrastive import make_batches
    from tdr_torch.train.mining import make_pseudo_queries

    t13 = time.perf_counter()
    pseudo = make_pseudo_queries(corpus, 1100, seed=11)
    cs.sharded_train_phase(list(itertools.islice(make_batches(
        pseudo, dict(zip(corpus.docids, corpus.texts)), cfg, 50, 2, seed=0),
        22)))
    tmp = tempfile.mkdtemp(prefix="tdr_cli_")
    try:
        cs.cli_train_phase(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cs.say(f"phase 13d: {time.perf_counter() - t13:.1f} s")


if __name__ == "__main__":
    main()
