from tdr_torch.models.sparse import BM25Model, SparseModel, TfidfCosineModel

__all__ = ["BM25Model", "SparseModel", "TfidfCosineModel"]
