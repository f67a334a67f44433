from tdr_torch.text.stopwords import stopwords_for, stopword_union, KO_STOPWORDS
from tdr_torch.text.preprocess import (
    Preprocessor,
    preprocess_text,
    preprocess_texts,
    PIPELINES,
)
from tdr_torch.text.vocab import Vocab, build_vocab, encode_docs, encode_queries
from tdr_torch.text.langid import detect_language

__all__ = [
    "stopwords_for",
    "stopword_union",
    "KO_STOPWORDS",
    "Preprocessor",
    "preprocess_text",
    "preprocess_texts",
    "PIPELINES",
    "Vocab",
    "build_vocab",
    "encode_docs",
    "encode_queries",
    "detect_language",
]
