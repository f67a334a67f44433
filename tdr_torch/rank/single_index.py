"""One shared index over the whole multilingual corpus, with the ranking
filtered to each query's language: the port of
``tdr/rank/single_index.py`` (the per-language router is the main path;
this variant is part of the reference's surface)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Type

import numpy as np
import torch

from tdr_torch.data.loaders import Corpus
from tdr_torch.models.sparse import SparseModel, TfidfCosineModel
from tdr_torch.ops.score import (WILDCARD_LANG, score_batch,
                                 topk_language_filtered)
from tdr_torch.text.preprocess import Preprocessor
from tdr_torch.utils.config import IndexConfig
from tdr_torch.utils.device import DeviceLike


@dataclass
class SingleIndexRetriever:
    """One index, all languages; ranking filtered to the query's language."""

    model: SparseModel
    doc_lang_codes: torch.Tensor          # (N_pad,) int32, -1 past n_docs
    lang_to_code: Dict[str, int]
    preprocessor: Preprocessor = field(default_factory=lambda: Preprocessor("best"))
    query_batch: int = 128

    @classmethod
    def build(cls, corpus: Corpus,
              model_cls: Type[SparseModel] = TfidfCosineModel,
              index_cfg: IndexConfig = IndexConfig(),
              preprocessor: Optional[Preprocessor] = None,
              device: DeviceLike = None, **model_kw) -> "SingleIndexRetriever":
        pp = preprocessor or Preprocessor("best")
        toks = [pp(t, l) for t, l in zip(corpus.texts, corpus.langs)]
        model = model_cls.build(toks, corpus.docids, lang="multi",
                                index_cfg=index_cfg, device=device, **model_kw)
        lang_to_code = {l: i for i, l in enumerate(sorted(set(corpus.langs)))}
        codes = np.full(model.index.n_docs_pad, -1, np.int32)
        codes[:len(corpus)] = [lang_to_code[l] for l in corpus.langs]
        return cls(model=model,
                   doc_lang_codes=torch.from_numpy(codes).to(model.device),
                   lang_to_code=lang_to_code, preprocessor=pp)

    def _query_code(self, query: str, lang: str) -> int:
        """A query's language code; an unknown language falls back to
        detection, then to unfiltered ranking."""
        code = self.lang_to_code.get(lang)
        if code is None:
            from tdr_torch.text.langid import detect_language

            code = self.lang_to_code.get(detect_language(query, default=""),
                                         WILDCARD_LANG)
        return code

    def retrieve(self, queries: Sequence[str], langs: Sequence[str],
                 k: int = 10) -> List[List[str]]:
        out: List[List[str]] = []
        m = self.model
        for s in range(0, len(queries), self.query_batch):
            chunk_q = list(queries[s:s + self.query_batch])
            chunk_l = list(langs[s:s + self.query_batch])
            n = len(chunk_q)
            pad = self.query_batch - n
            toks = [self.preprocessor(q, l) for q, l in zip(chunk_q, chunk_l)]
            qids, qw = m.encode_query_tokens(toks + [[]] * pad)
            q_codes = torch.tensor(
                [self._query_code(q, l) for q, l in zip(chunk_q, chunk_l)]
                + [WILDCARD_LANG] * pad, dtype=torch.int32, device=m.device)
            scores = score_batch(m.index, qids, qw)
            vals, rows = topk_language_filtered(
                scores, self.doc_lang_codes, q_codes,
                top_k=min(k, m.index.n_docs_pad))
            vals, rows = vals.cpu().numpy()[:n], rows.cpu().numpy()[:n]
            for qv, qr in zip(vals, rows):
                out.append([m.docids[r] for r, v in zip(qr, qv)
                            if np.isfinite(v) and r < len(m.docids)])
        return out
