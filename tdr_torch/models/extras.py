"""Auxiliary rankers: the port of ``tdr/models/extras.py``.

* ``LogisticRegressionRanker`` — the reference's from-scratch sigmoid +
  gradient-descent ranker (text_preprocessing_and_tfidf.py:112-144, 261-285:
  1000 epochs, lr 0.01): full-batch GD with the reference's schedule, a plain
  loop on the device (``tdr`` scans it under ``jit``).
* ``UnigramLanguageModel`` — the reference's unigram LM
  (text_preprocessing_and_embedding_setup.py:238-260): Laplace-smoothed
  corpus term log-probabilities; a query's score is the sum of its terms'
  log-probabilities (the reference multiplied raw probabilities; the log
  keeps the order and avoids underflow).

The products are f32 and run in full IEEE f32 (``ieee_f32``).  The term
counts are integer tf values, exact in f32 below 2**24, so ``from_index``
gives the same counts on every device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from tdr_torch.index.build import SparseIndex
from tdr_torch.ops.precision import ieee_f32
from tdr_torch.utils.device import DeviceLike, resolve_device


# --------------------------------------------------------------------------
# from-scratch logistic regression
# --------------------------------------------------------------------------

@ieee_f32()
def _train_logreg(X: torch.Tensor, y: torch.Tensor, lr: float, epochs: int):
    n, d = X.shape
    w = torch.zeros(d, dtype=torch.float32, device=X.device)
    b = torch.zeros((), dtype=torch.float32, device=X.device)
    for _ in range(epochs):
        p = torch.sigmoid(X @ w + b)
        dz = (p - y) / n
        w = w - lr * (X.T @ dz)
        b = b - lr * dz.sum()
    return w, b


@dataclass
class LogisticRegressionRanker:
    w: Optional[torch.Tensor] = None
    b: Optional[torch.Tensor] = None
    lr: float = 0.01
    epochs: int = 1000
    device: DeviceLike = None

    def fit(self, X, y) -> "LogisticRegressionRanker":
        dev = resolve_device(self.device)
        self.w, self.b = _train_logreg(
            torch.as_tensor(X, dtype=torch.float32, device=dev),
            torch.as_tensor(y, dtype=torch.float32, device=dev),
            self.lr, self.epochs)
        return self

    def predict_proba(self, X) -> np.ndarray:
        if self.w is None:
            raise ValueError("fit first")
        X = torch.as_tensor(X, dtype=torch.float32, device=self.w.device)
        with ieee_f32():
            return torch.sigmoid(X @ self.w + self.b).cpu().numpy()

    def rank(self, X, k: int = 10) -> np.ndarray:
        p = self.predict_proba(X)
        return np.argsort(-p, kind="stable")[:k]


# --------------------------------------------------------------------------
# unigram language model
# --------------------------------------------------------------------------

@dataclass
class UnigramLanguageModel:
    log_prob: torch.Tensor      # (V,) corpus unigram log-probabilities

    @classmethod
    def from_index(cls, index: SparseIndex,
                   smoothing: float = 1.0) -> "UnigramLanguageModel":
        """Corpus term counts from the CSR tf values (CountVectorizer
        equivalent), Laplace-smoothed, on the index's device."""
        V = index.vocab_size
        pos = torch.arange(index.postings_tf.shape[0], device=index.device,
                           dtype=index.indptr.dtype)
        terms = (torch.searchsorted(index.indptr, pos, right=True) - 1
                 ).clamp(0, V - 1)
        counts = torch.zeros(V, dtype=torch.float32, device=index.device)
        counts.index_add_(0, terms, index.postings_tf)
        probs = (counts + smoothing) / (counts.sum() + smoothing * V)
        return cls(torch.log(probs))

    def score_queries(self, qids, qw) -> np.ndarray:
        """Per-query log-probability under the corpus unigram model
        (compute_document_probability semantics, in log space)."""
        dev = self.log_prob.device
        qids = torch.as_tensor(qids, device=dev).long()
        qw = torch.as_tensor(qw, dtype=torch.float32, device=dev)
        lp = self.log_prob[qids.clamp(0, self.log_prob.shape[0] - 1)]
        return torch.where(qw > 0, lp * qw, 0.0).sum(dim=1).cpu().numpy()
