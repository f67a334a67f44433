from tdr_torch.data.loaders import (
    Corpus,
    QuerySet,
    load_corpus,
    load_queries,
    train_val_split,
    partition_by_language,
)
from tdr_torch.data.synthetic import synthetic_corpus, SyntheticSpec

__all__ = [
    "Corpus",
    "QuerySet",
    "load_corpus",
    "load_queries",
    "train_val_split",
    "partition_by_language",
    "synthetic_corpus",
    "SyntheticSpec",
]
