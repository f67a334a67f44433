from tdr_torch.train.contrastive import (
    ShardedTrainState,
    TrainState,
    batch_shardings,
    create_train_state,
    contrastive_loss,
    make_train_step,
    param_shardings,
    shard_batch,
    shard_train_state,
    train_dense_retriever,
    train_state_from_optax,
    unshard_train_state,
)
from tdr_torch.train.mining import (
    concat_querysets,
    make_pseudo_queries,
    mine_hard_negatives,
)

__all__ = [
    "ShardedTrainState",
    "TrainState",
    "batch_shardings",
    "param_shardings",
    "shard_batch",
    "shard_train_state",
    "unshard_train_state",
    "create_train_state",
    "contrastive_loss",
    "make_train_step",
    "train_dense_retriever",
    "train_state_from_optax",
    "concat_querysets",
    "make_pseudo_queries",
    "mine_hard_negatives",
]
