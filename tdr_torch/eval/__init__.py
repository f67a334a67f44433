from tdr_torch.eval.metrics import recall_at_k, mrr_at_k, ndcg_at_k, evaluate_retrieval, macro_f1

__all__ = ["recall_at_k", "mrr_at_k", "ndcg_at_k", "evaluate_retrieval", "macro_f1"]
