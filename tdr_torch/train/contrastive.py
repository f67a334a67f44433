"""Contrastive dual-encoder training: the port of ``tdr/train/contrastive.py``.

InfoNCE over in-batch negatives plus each query's explicit hard negatives,
with AdamW, on one device.  What ``tdr`` computes, in torch idiom:

* ``TrainState`` holds the ``DualEncoder``, its ``torch.optim.AdamW`` and the
  step count;
* ``optax.adamw(lr, weight_decay)`` (b1 0.9, b2 0.999, eps 1e-8, decay on
  every parameter, LayerNorm and biases included) is ``torch.optim.AdamW``
  with the same constants: the same update in another order of operations,
  so the two differ by ulps.  Optax's ``ScaleByAdamState`` maps onto torch's
  per-parameter state as ``count`` -> ``step``, ``mu`` -> ``exp_avg``,
  ``nu`` -> ``exp_avg_sq`` (``train_state_from_optax``, ``adam_moments``);
* the step (forward, loss, backward, optimizer update) runs inside
  ``ieee_f32()``: at ``dtype="float32"`` its products are full IEEE f32
  whatever the caller's TF32 setting, the backward's and the loss's too.

The sharded step (``tdr``'s ``shard_train_state`` over a DP x TP mesh) comes
with the parallel layer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tdr_torch.models.encoder import (DualEncoder, encoder_state_from_flax,
                                      init_encoder, module_device)
from tdr_torch.ops.precision import ieee_f32
from tdr_torch.utils.config import DenseConfig
from tdr_torch.utils.device import DeviceLike, resolve_device
from tdr_torch.utils.trace import log

ADAM_BETAS = (0.9, 0.999)          # optax.adamw's defaults
ADAM_EPS = 1e-8


@dataclass
class TrainState:
    model: DualEncoder
    optimizer: torch.optim.AdamW
    step: int = 0


def _adamw(model: DualEncoder, lr: float,
           weight_decay: float) -> torch.optim.AdamW:
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=ADAM_BETAS,
                             eps=ADAM_EPS, weight_decay=weight_decay)


def create_train_state(cfg: DenseConfig, lr: float = 3e-4,
                       weight_decay: float = 0.01, seed: int = 0,
                       device: DeviceLike = None) -> TrainState:
    model = init_encoder(cfg, seed, device=device)
    return TrainState(model, _adamw(model, lr, weight_decay))


def train_state_from_optax(params: Mapping, opt_state, step: int,
                           cfg: DenseConfig, lr: float,
                           weight_decay: float = 0.01,
                           device: DeviceLike = None) -> TrainState:
    """A ``TrainState`` at the point of a ``tdr`` one: ``params`` is the flax
    param tree and ``opt_state`` optax's AdamW state (its first element, or
    the ``ScaleByAdamState`` itself, with ``count``, ``mu`` and ``nu``), as
    numpy arrays.  Both packages then take their next step from the same
    weights and moments."""
    adam = opt_state[0] if isinstance(opt_state, (tuple, list)) else opt_state
    model = DualEncoder(cfg)
    model.load_state_dict(encoder_state_from_flax(params))
    model = model.to(resolve_device(device))
    opt = _adamw(model, lr, weight_decay)
    load_adam_moments(opt, model, int(np.asarray(adam.count)),
                      encoder_state_from_flax(adam.mu),
                      encoder_state_from_flax(adam.nu))
    return TrainState(model, opt, int(step))


def load_adam_moments(opt: torch.optim.AdamW, model: DualEncoder, count: int,
                      exp_avg: Mapping[str, torch.Tensor],
                      exp_avg_sq: Mapping[str, torch.Tensor]) -> None:
    """Set every parameter's AdamW state: ``count`` updates taken, first and
    second moments keyed by state-dict name."""
    for name, p in model.named_parameters():
        opt.state[p] = {
            # torch keeps the step as an f32 scalar on the CPU (not fused)
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": exp_avg[name].to(p.device, torch.float32).clone(),
            "exp_avg_sq": exp_avg_sq[name].to(p.device, torch.float32).clone(),
        }


Moments = Dict[str, torch.Tensor]


def adam_moments(state: TrainState) -> Tuple[int, Moments, Moments]:
    """The inverse of ``load_adam_moments``: (count, exp_avg, exp_avg_sq) by
    state-dict name, zeros before the first step (optax's init)."""
    counts, mu, nu = set(), {}, {}
    for name, p in state.model.named_parameters():
        st = state.optimizer.state.get(p, {})
        counts.add(int(st["step"]) if st else 0)
        mu[name] = st["exp_avg"] if st else torch.zeros_like(p)
        nu[name] = st["exp_avg_sq"] if st else torch.zeros_like(p)
    if len(counts) != 1:
        raise ValueError(f"parameters have taken different step counts "
                         f"{sorted(counts)}: not one optax count")
    return counts.pop(), mu, nu


def contrastive_loss(
    q_emb: torch.Tensor,                  # (B, D) normalized
    p_emb: torch.Tensor,                  # (B, D) normalized positives
    n_emb: Optional[torch.Tensor] = None,  # (B, Nn, D) explicit negatives
    temperature: float = 0.05,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """InfoNCE with in-batch negatives (+ optional hard negatives)."""
    B = q_emb.shape[0]
    with ieee_f32():
        logits = q_emb @ p_emb.T                              # (B, B)
        if n_emb is not None:
            neg = torch.einsum("bd,bnd->bn", q_emb, n_emb)    # (B, Nn)
            logits = torch.cat([logits, neg], dim=1)
    logits = logits / temperature
    labels = torch.arange(B, device=logits.device)
    loss = F.cross_entropy(logits, labels)
    acc = (logits.argmax(dim=1) == labels).float().mean()
    return loss, {"loss": loss.detach(), "accuracy": acc}


def batch_loss(model: DualEncoder, batch: Mapping[str, np.ndarray],
               temperature: float = 0.05):
    """The loss of one batch (``make_batches``' dict): one forward over the
    queries, positives and flattened negatives together (each row is
    encoded alone, so one call is three calls' results)."""
    dev = module_device(model)
    B, L = batch["q_ids"].shape
    parts = [("q_ids", "q_mask"), ("p_ids", "p_mask")]
    if "n_ids" in batch:
        parts.append(("n_ids", "n_mask"))

    def stacked(j):
        return torch.cat([torch.as_tensor(batch[p[j]]).reshape(-1, L)
                          for p in parts]).to(dev)

    emb = model(stacked(0), stacked(1))
    q, p = emb[:B], emb[B:2 * B]
    n = emb[2 * B:].reshape(B, -1, emb.shape[1]) if len(parts) == 3 else None
    return contrastive_loss(q, p, n, temperature)


def make_train_step(temperature: float = 0.05):
    """The train step: ``step_fn(state, batch) -> (state, metrics)`` updates
    ``state`` in place.  Metrics stay on the device (no sync a step)."""

    def step_fn(state: TrainState, batch: Mapping[str, np.ndarray]):
        with ieee_f32():
            loss, metrics = batch_loss(state.model, batch, temperature)
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            state.optimizer.step()
        state.step += 1
        return state, metrics

    return step_fn


# -- data pipeline (a copy of tdr's) ----------------------------------------

def make_batches(
    queries, corpus_texts_by_id: Dict[str, str], cfg: DenseConfig,
    batch_size: int, n_neg: int = 2, seed: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield hashed-encoded (query, positive, negatives) batches from a
    QuerySet with positive_docs / negative_docs (train.csv schema)."""
    from tdr_torch.text.hash_tokenizer import encode_batch

    rng = np.random.RandomState(seed)
    idx = [i for i, p in enumerate(queries.positive_docs or [])
           if p in corpus_texts_by_id]
    rng.shuffle(idx)
    all_ids = list(corpus_texts_by_id)
    for s in range(0, len(idx) - batch_size + 1, batch_size):
        sel = idx[s:s + batch_size]
        q_texts = [queries.queries[i] for i in sel]
        p_texts = [corpus_texts_by_id[queries.positive_docs[i]] for i in sel]
        n_texts = []
        for i in sel:
            negs = list(queries.negative_docs[i]) if queries.negative_docs else []
            negs = [n for n in negs if n in corpus_texts_by_id][:n_neg]
            while len(negs) < n_neg:
                negs.append(all_ids[rng.randint(len(all_ids))])
            n_texts.extend(corpus_texts_by_id[n] for n in negs)
        q_ids, q_mask = encode_batch(q_texts, cfg.vocab_size, cfg.max_len)
        p_ids, p_mask = encode_batch(p_texts, cfg.vocab_size, cfg.max_len)
        n_ids, n_mask = encode_batch(n_texts, cfg.vocab_size, cfg.max_len)
        B = len(sel)
        yield {
            "q_ids": q_ids, "q_mask": q_mask,
            "p_ids": p_ids, "p_mask": p_mask,
            "n_ids": n_ids.reshape(B, n_neg, -1),
            "n_mask": n_mask.reshape(B, n_neg, -1),
        }


def train_dense_retriever(
    corpus, train_queries, cfg: DenseConfig,
    epochs: int = 1, batch_size: int = 32, n_neg: int = 2,
    lr: float = 3e-4, seed: int = 0, device: DeviceLike = None,
) -> Tuple[DualEncoder, TrainState, Dict[str, float]]:
    """Full training loop (host data pipeline + device steps)."""
    state = create_train_state(cfg, lr=lr, seed=seed, device=device)
    step_fn = make_train_step()
    by_id = dict(zip(corpus.docids, corpus.texts))
    last: Dict[str, float] = {}
    curve = []
    for ep in range(epochs):
        metrics = None
        for batch in make_batches(train_queries, by_id, cfg, batch_size, n_neg,
                                  seed=seed + ep):
            state, metrics = step_fn(state, batch)
        if metrics is None:
            log.warning(
                "epoch %d: no full batch of usable (query, positive) pairs — "
                "need >= batch_size (%d) queries whose positives are in the "
                "corpus", ep, batch_size)
            break
        last = {k: float(v) for k, v in metrics.items()}
        curve.append(round(last.get("loss", float("nan")), 4))
        log.info("epoch %d: %s", ep, last)
    # per-epoch end-of-epoch losses — the training curve callers report
    last["loss_curve"] = curve
    return state.model, state, last
