from tdr_torch.utils.config import (
    BM25Config,
    DataConfig,
    DenseConfig,
    IndexConfig,
    MeshConfig,
    MlaMoeConfig,
    RetrievalConfig,
    TdrConfig,
)
from tdr_torch.utils.trace import phase_timer, Tracer

__all__ = [
    "BM25Config",
    "DataConfig",
    "DenseConfig",
    "IndexConfig",
    "MeshConfig",
    "MlaMoeConfig",
    "RetrievalConfig",
    "TdrConfig",
    "phase_timer",
    "Tracer",
]
