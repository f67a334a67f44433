from tdr_torch.index.build import (
    IndexStats,
    SparseIndex,
    build_index,
    build_tfidf_index,
    compute_idf,
    quantize_head,
    segment_df,
    select_head,
    sparse_index_from_arrays,
)

__all__ = [
    "IndexStats",
    "SparseIndex",
    "build_index",
    "build_tfidf_index",
    "compute_idf",
    "quantize_head",
    "segment_df",
    "select_head",
    "sparse_index_from_arrays",
]
