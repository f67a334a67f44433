"""Scoring ops of the port (``tdr.ops``'s exports).  Importing the package
builds and loads no kernel: ``tdr_torch.ops.cuda_build`` compiles the CUDA
sources at a wrapper's first launch."""

from tdr_torch.ops.score import (
    score_and_topk,
    score_and_topk_fused,
    score_batch,
    score_pairs,
    topk_language_filtered,
    topk_masked,
)

__all__ = [
    "score_batch",
    "score_and_topk",
    "score_and_topk_fused",
    "score_pairs",
    "topk_language_filtered",
    "topk_masked",
]
