from tdr_torch.eval.metrics import recall_at_k, mrr_at_k, ndcg_at_k, evaluate_retrieval, macro_f1
from tdr_torch.eval.submission import write_submission, validate_submission, read_submission

__all__ = [
    "recall_at_k",
    "macro_f1",
    "mrr_at_k",
    "ndcg_at_k",
    "evaluate_retrieval",
    "write_submission",
    "validate_submission",
    "read_submission",
]
