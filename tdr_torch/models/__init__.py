from tdr_torch.models.dense import DenseModel, evaluate_dense
from tdr_torch.models.encoder import DualEncoder, init_encoder
from tdr_torch.models.sparse import BM25Model, SparseModel, TfidfCosineModel

__all__ = ["BM25Model", "DenseModel", "DualEncoder", "SparseModel",
           "TfidfCosineModel", "evaluate_dense", "init_encoder"]
