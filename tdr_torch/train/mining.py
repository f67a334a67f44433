# Copied from tdr/train/mining.py; only the imports are rewritten.
"""Hard-negative mining + pseudo-query augmentation for encoder training.

The reference never trains its dense model (it re-ranks with a frozen HF
MiniLM, team_run1.py:207-295); its train.csv carries explicit negatives
but nothing refreshes them.  The trainer (tdr_torch/train/contrastive.py)
falls back to RANDOM corpus documents when explicit negatives are absent
— random negatives teach only coarse topical separation, which BM25
already provides, so the re-ranker learns nothing it can use at the
cascade boundary.

This module supplies the DPR/ANCE recipe the reference is missing:

* ``mine_hard_negatives`` — retrieve each training query's top-k with the
  SAME fused BM25 engine that serves (one batched device pass, not a
  corpus scan) and keep the top-ranked NON-positive docids as negatives.
  These are exactly the documents the cascade re-ranker must reorder at
  serve time, so the InfoNCE gradient concentrates on the decision
  boundary that matters.
* ``make_pseudo_queries`` — ICT-style (query, positive) pairs sampled
  from corpus text alone (no labels), to widen a thin train split.  Each
  pseudo-query is a handful of distinct tokens drawn from one document,
  biased toward that document's RARE tokens (min corpus df), mirroring
  how real lookup queries name a document by its distinctive terms.

Both return plain ``QuerySet``s so they compose with
``train_dense_retriever`` unchanged:

    pqs   = make_pseudo_queries(corpus, 2000)
    mined = mine_hard_negatives(router, concat_querysets([train, pqs]))
    train_dense_retriever(corpus, mined, cfg, n_neg=2, ...)
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import List, Optional, Sequence, Tuple

import numpy as np

from tdr_torch.data.loaders import Corpus, QuerySet


def concat_querysets(parts: Sequence[QuerySet]) -> QuerySet:
    """Concatenate QuerySets (positive_docs required on every part;
    negative_docs merged if present on all, else dropped)."""
    if not parts:
        raise ValueError("concat_querysets: need at least one QuerySet")
    for p in parts:
        if p.positive_docs is None:
            raise ValueError("concat_querysets: every part needs positive_docs")
    has_negs = all(p.negative_docs is not None for p in parts)
    return QuerySet(
        query_ids=[q for p in parts for q in p.query_ids],
        queries=[q for p in parts for q in p.queries],
        langs=[l for p in parts for l in p.langs],
        positive_docs=[d for p in parts for d in p.positive_docs],
        negative_docs=(
            [n for p in parts for n in p.negative_docs] if has_negs else None),
    )


def mine_hard_negatives(
    retriever,
    queries: QuerySet,
    n_neg: int = 2,
    depth: int = 20,
    skip_top: int = 0,
    seed: int = 0,
    fallback_docids: Optional[Sequence[str]] = None,
) -> QuerySet:
    """Attach retriever-mined hard negatives to a QuerySet.

    ``retriever`` is anything with the router interface
    ``retrieve(queries, langs, k) -> List[List[docid]]`` (LanguageRouter,
    CascadeRetriever, ShardedBM25Model via a router, ...).  For each query
    the top-``depth`` list is scanned in rank order, the positive is
    dropped, the first ``skip_top`` survivors are skipped (ANCE-style
    guard against unlabeled positives in shallow synthetic labelings),
    and the next ``n_neg`` become that query's negatives.  Queries whose
    list exhausts (fewer than ``n_neg`` non-positives retrieved) are
    padded from ``fallback_docids`` at random; if the fallback pool
    cannot supply ``n_neg`` DISTINCT eligible negatives (or no fallback
    was given) the query's list stays SHORT — the trainer's batcher
    (``make_batches``) pads short lists with random corpus docs, so
    training still works, but the pad is random, not mined; a warning
    is logged so the degradation is visible.

    One batched device pass over the training queries — at bench scale
    (~2k queries) this costs well under a second warm.
    """
    if queries.positive_docs is None:
        raise ValueError("mine_hard_negatives: queries need positive_docs")
    ranked = retriever.retrieve(queries.queries, queries.langs,
                                k=depth + 1 + skip_top)
    rng = np.random.RandomState(seed)
    fb = list(fallback_docids) if fallback_docids else []
    negs: List[List[str]] = []
    n_short = 0
    for docs, pos in zip(ranked, queries.positive_docs):
        hard = [d for d in docs if d != pos][skip_top:skip_top + n_neg]
        if len(hard) < n_neg and fb:
            # pad from a shuffled copy of the ELIGIBLE pool and stop when
            # it is exhausted — rejection-sampling from the fixed pool
            # hangs forever when fewer than n_neg distinct eligible ids
            # exist (ADVICE r4: reproduced with fallback_docids=[pos])
            pool = [d for d in set(fb) if d != pos and d not in hard]
            rng.shuffle(pool)
            hard.extend(pool[:n_neg - len(hard)])
        n_short += len(hard) < n_neg
        negs.append(hard)
    if n_short:
        from tdr_torch.utils.trace import log

        log.warning(
            "mine_hard_negatives: %d quer%s got fewer than n_neg=%d "
            "negatives (retrieval exhausted and the fallback pool ran "
            "dry) — the trainer pads them with RANDOM docs",
            n_short, "y" if n_short == 1 else "ies", n_neg)
    return dataclasses.replace(queries, negative_docs=negs)


def _doc_freq(tok_lists: Sequence[Sequence[str]]) -> Counter:
    df: Counter = Counter()
    for toks in tok_lists:
        df.update(set(toks))
    return df


def make_pseudo_queries(
    corpus: Corpus,
    n_queries: int,
    terms_lo: int = 3,
    terms_hi: int = 6,
    seed: int = 0,
    id_prefix: str = "pq",
) -> QuerySet:
    """ICT-style pseudo (query, positive) pairs from corpus text alone.

    Sampling is df-weighted toward each document's RARE tokens (weight
    1/df over a whitespace-token document frequency computed on the fly):
    real lookup queries name a document by its distinctive terms, and
    uniform sampling would mostly draw stopword-ish high-df tokens that
    match thousands of documents.  Uses only the corpus — no eval or
    train labels — so it is legitimate augmentation wherever the corpus
    itself is available.
    """
    if len(corpus) == 0:
        raise ValueError("make_pseudo_queries: empty corpus")
    rng = np.random.RandomState(seed)
    tok_lists = [sorted({t for t in txt.split() if len(t) >= 2})
                 for txt in corpus.texts]
    df = _doc_freq(tok_lists)
    # eligible documents are fixed up front: sampling-with-retry over the
    # whole corpus never terminates when NO document clears terms_lo
    # (ADVICE r4: reproduced with a 2-doc corpus of short tokens)
    eligible = np.array([i for i, t in enumerate(tok_lists)
                         if len(t) >= terms_lo], np.int64)
    if eligible.size == 0:
        raise ValueError(
            "make_pseudo_queries: no document has >= terms_lo distinct "
            f"tokens of length >= 2 (terms_lo={terms_lo})")
    qids, q_texts, q_langs, q_pos = [], [], [], []
    doc_pick = eligible[rng.randint(0, eligible.size, size=n_queries)]
    for i in doc_pick:
        i = int(i)
        toks = tok_lists[i]
        k = int(rng.randint(terms_lo, min(terms_hi, len(toks)) + 1))
        w = np.array([1.0 / df[t] for t in toks])
        sel = rng.choice(len(toks), size=k, replace=False, p=w / w.sum())
        qids.append(f"{id_prefix}{len(q_texts)}")
        q_texts.append(" ".join(toks[j] for j in sorted(sel)))
        q_langs.append(corpus.langs[i])
        q_pos.append(corpus.docids[i])
    return QuerySet(qids, q_texts, q_langs, positive_docs=q_pos)
