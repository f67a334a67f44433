from tdr_torch.rank.router import LanguageRouter, build_language_models
from tdr_torch.rank.cascade import CascadeRetriever, cascade_score_topk
from tdr_torch.rank.sentence import (SentenceBM25, SentenceLmCascade,
                                     candidate_union)
from tdr_torch.rank.single_index import SingleIndexRetriever
from tdr_torch.rank.segmented import SegmentedBM25
from tdr_torch.rank.fuse import rrf_fuse
from tdr_torch.rank.feedback import DocMajorIndex, build_doc_major, prf_expand

__all__ = ["LanguageRouter", "build_language_models", "CascadeRetriever",
           "cascade_score_topk", "SentenceBM25", "SentenceLmCascade",
           "candidate_union", "SingleIndexRetriever", "SegmentedBM25",
           "DocMajorIndex", "build_doc_major", "prf_expand", "rrf_fuse"]
