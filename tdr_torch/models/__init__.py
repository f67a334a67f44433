from tdr_torch.models.convert import (BertConfig, BertEncoder,
                                      convert_hf_bert, init_bert_encoder,
                                      load_sentence_transformer,
                                      minilm_l12_config)
from tdr_torch.models.dense import DenseModel, evaluate_dense
from tdr_torch.models.encoder import DualEncoder, init_encoder
from tdr_torch.models.mla_moe import MlaMoeEncoder, init_mla_moe
from tdr_torch.models.sparse import BM25Model, SparseModel, TfidfCosineModel

__all__ = ["BM25Model", "BertConfig", "BertEncoder", "DenseModel",
           "DualEncoder", "MlaMoeEncoder", "SparseModel", "TfidfCosineModel",
           "convert_hf_bert", "evaluate_dense", "init_bert_encoder",
           "init_encoder", "init_mla_moe", "load_sentence_transformer",
           "minilm_l12_config"]
