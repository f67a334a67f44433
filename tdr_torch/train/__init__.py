from tdr_torch.train.contrastive import (
    TrainState,
    create_train_state,
    contrastive_loss,
    make_train_step,
    train_dense_retriever,
    train_state_from_optax,
)
from tdr_torch.train.mining import (
    concat_querysets,
    make_pseudo_queries,
    mine_hard_negatives,
)

__all__ = [
    "TrainState",
    "create_train_state",
    "contrastive_loss",
    "make_train_step",
    "train_dense_retriever",
    "train_state_from_optax",
    "concat_querysets",
    "make_pseudo_queries",
    "mine_hard_negatives",
]
