# Copied from tdr/data/loaders.py; only the imports are rewritten.
"""L0 data ingest: corpus.json / query CSV loaders, splits, language partition.

I/O contract mirrors the reference (SURVEY.md §0):
  * ``corpus.json``: list of ``{docid, text, lang}`` objects
    (loaded at bm25_ranking.ipynb "load_corpus",
    cosine_similarity_bm25_reranking.py:262-276).
  * ``train.csv``: ``query_id, query, positive_docs, negative_docs, lang``;
    ``dev.csv``/``test.csv``: same minus negatives / labels.
  * train/val split: 90/10, seed 42 (bm25_ranking.ipynb:260).
"""

from __future__ import annotations

import ast
import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class Corpus:
    docids: List[str]
    texts: List[str]
    langs: List[str]

    def __len__(self) -> int:
        return len(self.docids)

    def __getitem__(self, idx) -> "Corpus":
        if isinstance(idx, (list, np.ndarray)):
            return Corpus(
                [self.docids[i] for i in idx],
                [self.texts[i] for i in idx],
                [self.langs[i] for i in idx],
            )
        raise TypeError(idx)


@dataclass
class QuerySet:
    query_ids: List[str]
    queries: List[str]
    langs: List[str]
    positive_docs: Optional[List[str]] = None      # dev/train only
    negative_docs: Optional[List[List[str]]] = None  # train only

    def __len__(self) -> int:
        return len(self.queries)

    def subset(self, idx: Sequence[int]) -> "QuerySet":
        pick = lambda xs: [xs[i] for i in idx] if xs is not None else None
        return QuerySet(
            pick(self.query_ids), pick(self.queries), pick(self.langs),
            pick(self.positive_docs), pick(self.negative_docs),
        )


def load_corpus(path: str, use_native: bool = True) -> Corpus:
    """corpus.json → Corpus (load_corpus, bm25_ranking.ipynb cell 2).

    Routes through the C++ streaming parser (tdr/native/jsonload.cc) when
    available (measured ~1.2x json.load at 100k docs — the parse itself is
    fast; Python string materialization is the shared floor), with
    json.load as fallback and parity oracle (tests/test_native.py)."""
    if use_native:
        try:
            from tdr_torch import native

            with open(path, "rb") as f:
                docids, texts, langs = native.parse_corpus_json(f.read())
            return Corpus(docids, texts, langs)
        except Exception:
            pass   # malformed/unsupported input or missing lib: fall back
    with open(path) as f:
        raw = json.load(f)
    return Corpus(
        [str(r["docid"]) for r in raw],
        [r["text"] for r in raw],
        [r.get("lang", "en") for r in raw],
    )


def _parse_neg(val) -> List[str]:
    if val is None or val == "" or (isinstance(val, float) and np.isnan(val)):
        return []
    if isinstance(val, str) and val.startswith("["):
        try:
            return [str(x) for x in ast.literal_eval(val)]
        except (ValueError, SyntaxError):
            return [val]
    return [str(val)]


def load_queries(path: str) -> QuerySet:
    import pandas as pd

    df = pd.read_csv(path)
    cols = {c.lower(): c for c in df.columns}
    qid_col = cols.get("query_id") or cols.get("id")
    q_col = cols.get("query")
    lang_col = cols.get("lang")
    pos_col = cols.get("positive_docs")
    neg_col = cols.get("negative_docs")
    return QuerySet(
        query_ids=[str(x) for x in df[qid_col]] if qid_col else [str(i) for i in range(len(df))],
        queries=list(df[q_col].astype(str)),
        langs=list(df[lang_col].astype(str)) if lang_col else ["en"] * len(df),
        positive_docs=[str(x) for x in df[pos_col]] if pos_col else None,
        negative_docs=[_parse_neg(x) for x in df[neg_col]] if neg_col else None,
    )


def train_val_split(
    qs: QuerySet, val_fraction: float = 0.1, seed: int = 42
) -> Tuple[QuerySet, QuerySet]:
    """Shuffled 90/10 split with a fixed seed (bm25_ranking.ipynb:260 uses
    sklearn train_test_split(test_size=0.1, random_state=42))."""
    n = len(qs)
    rng = np.random.RandomState(seed)
    perm = rng.permutation(n)
    n_val = int(round(n * val_fraction))
    val_idx, train_idx = perm[:n_val], perm[n_val:]
    return qs.subset(sorted(train_idx)), qs.subset(sorted(val_idx))


def partition_by_language(corpus: Corpus) -> Dict[str, np.ndarray]:
    """lang → int32 array of corpus row indices
    (the reference's lang_to_doc_indices, bm25_ranking.ipynb:262-270)."""
    out: Dict[str, List[int]] = {}
    for i, lang in enumerate(corpus.langs):
        out.setdefault(lang, []).append(i)
    return {k: np.asarray(v, dtype=np.int32) for k, v in out.items()}
