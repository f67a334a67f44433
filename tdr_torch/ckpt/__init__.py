from tdr_torch.ckpt.registry import (
    load_dense_model,
    load_registry,
    load_segmented,
    load_sparse_model,
    load_train_state,
    recover_segmented_dir,
    save_dense_model,
    save_registry,
    save_segmented,
    save_sparse_model,
    save_train_state,
)

__all__ = [
    "save_registry",
    "load_registry",
    "save_sparse_model",
    "load_sparse_model",
    "save_dense_model",
    "load_dense_model",
    "save_segmented",
    "load_segmented",
    "recover_segmented_dir",
    "save_train_state",
    "load_train_state",
]
