"""Contrastive dual-encoder training: the port of ``tdr/train/contrastive.py``.

InfoNCE over in-batch negatives plus each query's explicit hard negatives,
with AdamW, on one device or sharded over a mesh.  What ``tdr`` computes,
in torch idiom:

* ``TrainState`` holds the encoder (a ``DualEncoder``, or the MLA + MoE
  ``MlaMoeEncoder`` of ``models.mla_moe``), its AdamW (``ops.adamw.AdamW``:
  ``torch.optim.AdamW``, whose update of CUDA parameters is one
  hand-written kernel launch a step) and the step count;
* ``optax.adamw(lr, weight_decay)`` (b1 0.9, b2 0.999, eps 1e-8, decay on
  every parameter, LayerNorm and biases included) is ``torch.optim.AdamW``
  with the same constants: the same update in another order of operations,
  so the two differ by ulps.  Optax's ``ScaleByAdamState`` maps onto torch's
  per-parameter state as ``count`` -> ``step``, ``mu`` -> ``exp_avg``,
  ``nu`` -> ``exp_avg_sq`` (``train_state_from_optax``, ``adam_moments``);
* the step (forward, loss, backward, optimizer update) runs inside
  ``ieee_f32()``: at ``dtype="float32"`` its products are full IEEE f32
  whatever the caller's TF32 setting, the backward's and the loss's too;
* an encoder with a ``forward_with_aux`` (the MoE's) returns its auxiliary
  loss beside the embeddings, and the step adds it to InfoNCE.

The sharded step (``DualEncoder`` only) is ``tdr``'s ``shard_train_state``
path over a DP x TP mesh (``tdr_torch.parallel.mesh``):
``shard_train_state`` lays a ``TrainState`` out as a ``ShardedTrainState``
(each shard's parameter slices and their AdamW moments on its device,
``param_shardings``),
and the same ``make_train_step`` runs it on a whole batch: ``shard_batch``
splits the batch over "data", the tensor-parallel forward
(``models.encoder.encode_shards``) encodes each data shard's rows, the
loss over the whole batch (each data shard's embeddings gathered, as
differentiable copies, before the in-batch logits), the backward, the
gradients summed over the shards that hold a parameter, and every shard's
AdamW update.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import (Dict, Iterable, Iterator, List, Mapping, Optional, Tuple,
                    Union)

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tdr_torch.models.encoder import (DualEncoder, encode_shards,
                                      encoder_state_from_flax, init_encoder,
                                      module_device)
from tdr_torch.models.mla_moe import init_mla_moe
from tdr_torch.ops.adamw import AdamW
from tdr_torch.ops.precision import ieee_f32
from tdr_torch.parallel import train as tp
from tdr_torch.parallel.mesh import Mesh, _copy, data_sharding
from tdr_torch.utils.config import DenseConfig, MlaMoeConfig
from tdr_torch.utils.device import DeviceLike, resolve_device
from tdr_torch.utils.trace import annotate, log

ADAM_BETAS = (0.9, 0.999)          # optax.adamw's defaults
ADAM_EPS = 1e-8


@dataclass
class TrainState:
    model: nn.Module
    optimizer: AdamW
    step: int = 0


def _adamw(model: nn.Module, lr: float, weight_decay: float) -> AdamW:
    return AdamW(model.parameters(), lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS,
                 weight_decay=weight_decay)


def create_train_state(cfg: Union[DenseConfig, MlaMoeConfig],
                       lr: float = 3e-4, weight_decay: float = 0.01,
                       seed: int = 0,
                       device: DeviceLike = None) -> TrainState:
    """A fresh encoder and its AdamW: a ``DualEncoder`` for a
    ``DenseConfig`` (drawn on the CPU, then moved), an ``MlaMoeEncoder``
    for an ``MlaMoeConfig`` (drawn on ``device`` itself)."""
    if isinstance(cfg, MlaMoeConfig):
        model = init_mla_moe(cfg, seed, device=device)
    else:
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
    load_adam_moments(opt, model.named_parameters(),
                      int(np.asarray(adam.count)),
                      encoder_state_from_flax(adam.mu),
                      encoder_state_from_flax(adam.nu))
    return TrainState(model, opt, int(step))


NamedParams = Iterable[Tuple[str, torch.Tensor]]


def load_adam_moments(opt: torch.optim.AdamW, named_params: NamedParams,
                      count: int, exp_avg: Mapping[str, torch.Tensor],
                      exp_avg_sq: Mapping[str, torch.Tensor]) -> None:
    """Set every parameter's AdamW state: ``count`` updates taken, first and
    second moments keyed by state-dict name, copied into f32 tensors laid
    out like their parameter, as torch makes them (a moment carried from
    flax's layout is a transposed view; the card's kernel takes the
    parameter's layout)."""
    for name, p in named_params:
        opt.state[p] = {
            # torch keeps the step as an f32 scalar on the CPU (not fused)
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": torch.empty_like(p, dtype=torch.float32).copy_(
                exp_avg[name]),
            "exp_avg_sq": torch.empty_like(p, dtype=torch.float32).copy_(
                exp_avg_sq[name]),
        }


Moments = Dict[str, torch.Tensor]


def adam_moments(state: TrainState) -> Tuple[int, Moments, Moments]:
    """The inverse of ``load_adam_moments``: (count, exp_avg, exp_avg_sq) by
    state-dict name, zeros before the first step (optax's init)."""
    return optimizer_moments(state.optimizer, state.model.named_parameters())


def optimizer_moments(opt: torch.optim.AdamW, named_params: NamedParams
                      ) -> Tuple[int, Moments, Moments]:
    counts, mu, nu = set(), {}, {}
    for name, p in named_params:
        st = opt.state.get(p, {})
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


def _stacked(batch: Mapping, dev: torch.device):
    """The batch's queries, positives and flattened negatives as one (ids,
    mask) pair of row blocks on ``dev`` (each row is encoded alone, so one
    forward is three forwards' results).  A copy from pageable host memory
    waits for the device's stream."""
    L = batch["q_ids"].shape[1]
    parts = [("q_ids", "q_mask"), ("p_ids", "p_mask")]
    if "n_ids" in batch:
        parts.append(("n_ids", "n_mask"))
    out = []
    for j in (0, 1):
        block = torch.cat([torch.as_tensor(batch[p[j]]).reshape(-1, L)
                           for p in parts])
        with annotate("tdr_torch.sync.batch_h2d"):
            out.append(block.to(dev))
    return tuple(out)


def _split(emb: torch.Tensor, B: int, with_neg: bool):
    q, p = emb[:B], emb[B:2 * B]
    n = emb[2 * B:].reshape(B, -1, emb.shape[1]) if with_neg else None
    return q, p, n


def batch_loss(model: nn.Module, batch: Mapping[str, np.ndarray],
               temperature: float = 0.05):
    """The loss of one batch (``make_batches``' dict): one forward over the
    queries, positives and flattened negatives together.  An encoder with
    a ``forward_with_aux`` adds its auxiliary loss (the MoE's balance
    loss): ``metrics["loss"]`` is then the sum, ``metrics["aux_loss"]``
    the part it added."""
    stacked = _stacked(batch, module_device(model))
    with_aux = getattr(model, "forward_with_aux", None)
    emb, aux = with_aux(*stacked) if with_aux else (model(*stacked), None)
    q, p, n = _split(emb, batch["q_ids"].shape[0], "n_ids" in batch)
    loss, metrics = contrastive_loss(q, p, n, temperature)
    if aux is None:
        return loss, metrics
    loss = loss + aux
    return loss, dict(metrics, loss=loss.detach(), aux_loss=aux.detach())


def make_train_step(temperature: float = 0.05):
    """The train step: ``step_fn(state, batch) -> (state, metrics)`` updates
    ``state`` in place, a ``TrainState`` or a ``ShardedTrainState`` (which
    splits the batch itself, ``shard_batch``).  Metrics stay on the device
    (no sync a step)."""

    def step_fn(state, batch):
        if isinstance(state, ShardedTrainState):
            return _sharded_step(state, batch, temperature)
        with ieee_f32():
            with annotate("tdr_torch.train.forward"):
                loss, metrics = batch_loss(state.model, batch, temperature)
            with annotate("tdr_torch.train.optimizer"):
                state.optimizer.zero_grad(set_to_none=True)
            with annotate("tdr_torch.train.backward"):
                loss.backward()
            with annotate("tdr_torch.train.optimizer"):
                state.optimizer.step()
        state.step += 1
        return state, metrics

    return step_fn


# -- the sharded step (tdr/train/contrastive.py:103-161) --------------------

Spec = tp.Spec
ShardedBatch = List[List[Dict[str, torch.Tensor]]]


@dataclass
class ShardedTrainState:
    """A ``TrainState`` laid out over a ("data", "model") mesh:
    ``params[d][m]`` holds shard (d, m)'s parameter slices (leaf tensors on
    ``mesh.devices[d, m]``, by state-dict name, split as ``specs`` says)
    and ``optimizers[d][m]`` their AdamW, whose moments are laid out like
    the params.  The step count is replicated (one int)."""

    mesh: Mesh
    cfg: DenseConfig
    specs: Dict[str, Spec]
    params: List[List[Dict[str, torch.Tensor]]]
    optimizers: List[List[AdamW]]
    step: int = 0

    def per_device_bytes(self) -> Dict[str, int]:
        """Bytes of parameters and AdamW moments on each device."""
        out: Dict[str, int] = {}
        for row, opts in zip(self.params, self.optimizers):
            for params, opt in zip(row, opts):
                for p in params.values():
                    st = opt.state.get(p, {})
                    n = sum(t.numel() * t.element_size() for t in
                            [p] + [st[k] for k in ("exp_avg", "exp_avg_sq")
                                   if k in st])
                    out[str(p.device)] = out.get(str(p.device), 0) + n
        return out


def param_shardings(mesh: Mesh, model: DualEncoder) -> Dict[str, Spec]:
    """Each parameter's split by state-dict name, as a partition spec in
    the torch tensor's layout (``tdr``'s ``nn.with_partitioning``
    metadata, ``tp.PARAM_SPLITS``); raises where a split does not divide
    over the mesh's "model" axis, or for an encoder other than a
    ``DualEncoder``."""
    if not isinstance(model, DualEncoder):
        raise TypeError(f"the sharded train step takes a DualEncoder, not "
                        f"a {type(model).__name__}")
    n = mesh.shape["model"]
    specs = {}
    for name, p in model.named_parameters():
        spec = tp.param_spec(name, p.ndim)
        tp.shard_slice(p, spec, 0, n)        # raises on an uneven split
        specs[name] = spec
    if model.cfg.heads % n:
        raise ValueError(f"{model.cfg.heads} heads do not split over {n} "
                         f"model shards")
    return specs


def shard_train_state(mesh: Mesh, state: TrainState) -> ShardedTrainState:
    """Lay out params and AdamW moments over the mesh: each shard takes its
    slice of every parameter (``param_shardings``) and the same slice of
    ``exp_avg``/``exp_avg_sq`` (replicating the moments would forfeit the
    tensor-parallel memory saving); the step count is replicated."""
    specs = param_shardings(mesh, state.model)
    count, mu, nu = adam_moments(state)
    full = dict(state.model.named_parameters())
    group = state.optimizer.param_groups[0]
    n_model = mesh.shape["model"]

    def shard(d, m):
        dev = mesh.devices[d, m]

        def local(x, name):
            return tp.shard_slice(x, specs[name], m, n_model).detach().to(
                dev, copy=True)

        params = {k: local(v, k).requires_grad_() for k, v in full.items()}
        opt = AdamW(list(params.values()), lr=group["lr"],
                    betas=group["betas"], eps=group["eps"],
                    weight_decay=group["weight_decay"])
        load_adam_moments(opt, params.items(), count,
                          {k: local(v, k) for k, v in mu.items()},
                          {k: local(v, k) for k, v in nu.items()})
        return params, opt

    shards = [[shard(d, m) for m in range(n_model)]
              for d in range(mesh.shape["data"])]
    return ShardedTrainState(mesh, state.model.cfg, specs,
                             [[p for p, _ in row] for row in shards],
                             [[o for _, o in row] for row in shards],
                             state.step)


def unshard_train_state(state: ShardedTrainState,
                        device: DeviceLike = None) -> TrainState:
    """The ``TrainState`` a sharded one holds (data replica 0's slices
    joined), on ``device`` (the mesh's first device by default)."""
    dev = resolve_device(device) if device is not None else state.mesh.first
    row, opts = state.params[0], state.optimizers[0]
    moments = [optimizer_moments(o, p.items()) for o, p in zip(opts, row)]
    counts = {c for c, _, _ in moments}
    if len(counts) != 1:
        raise ValueError(f"model shards have taken different step counts "
                         f"{sorted(counts)}")

    def joined(trees):
        return {k: tp.join_slices([t[k].detach() for t in trees],
                                  state.specs[k]).to(dev)
                for k in state.specs}

    model = DualEncoder(state.cfg)
    model.load_state_dict(joined(row))
    model = model.to(dev)
    group = opts[0].param_groups[0]
    opt = _adamw(model, group["lr"], group["weight_decay"])
    load_adam_moments(opt, model.named_parameters(), counts.pop(),
                      joined([mu for _, mu, _ in moments]),
                      joined([nu for _, _, nu in moments]))
    return TrainState(model, opt, state.step)


def batch_shardings(mesh: Mesh, batch: Mapping) -> Dict[str, Spec]:
    """Each batch array split on its batch axis over "data"."""
    return {k: ("data",) + (None,) * (np.ndim(v) - 1)
            for k, v in batch.items()}


def shard_batch(mesh: Mesh, batch: Mapping) -> ShardedBatch:
    """``batch[d][m]``: data shard d's rows of every array, on
    ``mesh.devices[d, m]``; raises where the batch does not split evenly
    over "data"."""
    blocks = {k: data_sharding(mesh, torch.as_tensor(v))
              for k, v in batch.items()}
    return [[{k: _copy(b[d], mesh.devices[d, m]) for k, b in blocks.items()}
             for m in range(mesh.shape["model"])]
            for d in range(mesh.shape["data"])]


def sharded_batch_loss(state: ShardedTrainState, batch: ShardedBatch,
                       temperature: float = 0.05):
    """The global InfoNCE loss: each data shard encodes its rows with the
    tensor-parallel forward, and the embeddings are gathered (as
    differentiable copies) onto the mesh's first device before the (B, B)
    in-batch logits."""
    dest = state.mesh.first
    with_neg = "n_ids" in batch[0][0]
    parts = []                               # (q, p, n) of each data shard
    for row, rows in zip(state.params, batch):
        stacked = [_stacked(r, r["q_ids"].device) for r in rows]
        emb = encode_shards(row, state.cfg, [s[0] for s in stacked],
                            [s[1] for s in stacked])
        parts.append(_split(_copy(emb, dest), rows[0]["q_ids"].shape[0],
                            with_neg))
    q, p, n = (torch.cat(x) if x[0] is not None else None
               for x in zip(*parts))
    return contrastive_loss(q, p, n, temperature)


def _sharded_step(state: ShardedTrainState, batch: Mapping,
                  temperature: float):
    batch = shard_batch(state.mesh, batch)
    with ieee_f32():
        loss, metrics = sharded_batch_loss(state, batch, temperature)
        for opts in state.optimizers:
            for opt in opts:
                opt.zero_grad(set_to_none=True)
        loss.backward()
        tp.reduce_grads(state.mesh, state.params, state.specs)
        for opts in state.optimizers:
            for opt in opts:
                opt.step()
    state.step += 1
    return state, metrics


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
    mesh: Optional[Mesh] = None,
    epochs: int = 1, batch_size: int = 32, n_neg: int = 2,
    lr: float = 3e-4, seed: int = 0, device: DeviceLike = None,
) -> Tuple[DualEncoder, Union[TrainState, ShardedTrainState],
           Dict[str, float]]:
    """Full training loop (host data pipeline + device steps).  With a
    ``mesh`` the state is sharded once (on the mesh's devices; ``device``
    then only places the initial state) and each batch per step; the
    returned encoder is the trained state's, joined on the mesh's first
    device."""
    state = create_train_state(cfg, lr=lr, seed=seed, device=device)
    if mesh is not None:
        state = shard_train_state(mesh, state)
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
    model = (unshard_train_state(state).model if mesh is not None
             else state.model)
    return model, state, last
