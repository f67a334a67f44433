"""Checkpoints for the port, in the on-disk format of ``tdr/ckpt/registry.py``:

    <dir>/manifest.json                 versions, languages, extra metadata
    <dir>/<lang>/arrays.npz             index arrays (bf16 stored as uint16)
    <dir>/<lang>/vocab.txt[.pairs.npy]  term strings (+ packed bigram pairs)
    <dir>/<lang>/docids.txt, meta.json
    <dense dir>/params.npz, index.npz, docids.txt, meta.json
    <segmented dir>/main/..., segments.json
    <train dir>/train_state.npz, meta.json

Files written by either package load in the other: a bf16 array is stored
as its uint16 bits with the dtype string beside it, an int8 head carries
``head_scale``, and a dense model's ``p{i}`` leaves follow flax's flatten
order of the encoder's param tree (the keys sorted at every level).
A training state (``save_train_state``) stores jax's flattened
``TrainState`` leaves, so either package resumes from the other's file.
A sharded index (``save_sharded_index``) keeps ``tdr``'s directory:
``shared.npz``, ``shard_NNNN.npz`` per shard and ``manifest.json``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tdr_torch.index.build import sparse_index_from_arrays
from tdr_torch.models.sparse import BM25Model, SparseModel, TfidfCosineModel
from tdr_torch.text.vocab import Vocab
from tdr_torch.utils.device import DeviceLike, resolve_device

# 1 = original layout; 2 = int8-quantized arrays present (head_scale /
# doc_scale), so that older readers refuse them
FORMAT_VERSION = 2

_MODEL_TYPES = {"BM25Model": BM25Model, "TfidfCosineModel": TfidfCosineModel}
_INDEX_ARRAYS = ("indptr", "postings_doc", "postings_w", "postings_tf",
                 "head_slot", "head_rows")
_STATS_ARRAYS = ("df", "idf", "doc_len", "avgdl")
_STATIC_FIELDS = ("n_docs", "n_docs_pad", "vocab_size", "tail_pmax", "head_size")


def _to_numpy_savable(x: torch.Tensor) -> Tuple[np.ndarray, str]:
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = x.numpy()
    return arr, str(arr.dtype)


def _f32_from_saved(arr: np.ndarray, dtype: str) -> np.ndarray:
    """A saved float leaf as f32 numpy (bf16 is stored as its uint16 bits)."""
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16).float().numpy()
    return np.asarray(arr, np.float32)


def _check_version(meta: dict) -> None:
    if meta.get("format_version", 1) > FORMAT_VERSION:
        raise ValueError(f"checkpoint format {meta['format_version']} is newer "
                         f"than this build ({FORMAT_VERSION})")


# --------------------------------------------------------------------------
# sparse models
# --------------------------------------------------------------------------

def save_sparse_model(path: str, model: SparseModel) -> None:
    os.makedirs(path, exist_ok=True)
    ix = model.index
    arrays: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, str] = {}
    for name in _INDEX_ARRAYS:
        arrays[name], dtypes[name] = _to_numpy_savable(getattr(ix, name))
    if ix.head_scale is not None:
        arrays["head_scale"], dtypes["head_scale"] = _to_numpy_savable(
            ix.head_scale)
    for name in _STATS_ARRAYS:
        key = f"stats_{name}"
        arrays[key], dtypes[key] = _to_numpy_savable(getattr(ix.stats, name))
    arrays["vocab_df"] = np.asarray(model.vocab.df)
    np.savez(os.path.join(path, "arrays.npz"), **arrays)

    with open(os.path.join(path, "vocab.txt"), "w") as f:
        terms = sorted(model.vocab.term_to_id.items(), key=lambda kv: kv[1])
        # term ids may be non-contiguous when bigram pairs exist
        f.write("\n".join(f"{i}\t{t}" for t, i in terms))
    if model.vocab.pair_to_id:
        pairs = np.array(sorted(model.vocab.pair_to_id.items()), dtype=np.int64)
        np.save(os.path.join(path, "vocab.pairs.npy"), pairs)
    with open(os.path.join(path, "docids.txt"), "w") as f:
        f.write("\n".join(model.docids))

    meta = {
        "format_version": 2 if ix.head_scale is not None else 1,
        "model_type": type(model).__name__,
        "lang": model.lang,
        "max_query_terms": model.max_query_terms,
        "query_weight": model.query_weight,
        "tail_budget": model.tail_budget,
        "use_fused_topk": model.use_fused_topk,
        "statics": {k: int(getattr(ix, k)) for k in _STATIC_FIELDS},
        "dtypes": dtypes,
        "vocab_n_docs": model.vocab.n_docs,
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)


def load_sparse_model(path: str, device: DeviceLike = None) -> SparseModel:
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    _check_version(meta)
    data = np.load(os.path.join(path, "arrays.npz"))
    arrays = {k: data[k] for k in data.files}
    index = sparse_index_from_arrays(arrays, meta, device=device)

    term_to_id: Dict[str, int] = {}
    with open(os.path.join(path, "vocab.txt")) as f:
        for line in f:
            if line.rstrip("\n"):
                i, t = line.rstrip("\n").split("\t", 1)
                term_to_id[t] = int(i)
    pair_to_id = None
    pairs_path = os.path.join(path, "vocab.pairs.npy")
    if os.path.exists(pairs_path):
        pair_to_id = {int(k): int(v) for k, v in np.load(pairs_path)}
    vocab = Vocab(term_to_id, arrays["vocab_df"], meta["vocab_n_docs"],
                  pair_to_id=pair_to_id)
    with open(os.path.join(path, "docids.txt")) as f:
        docids = f.read().splitlines()
    cls = _MODEL_TYPES[meta["model_type"]]
    return cls(vocab=vocab, index=index, docids=docids, lang=meta["lang"],
               max_query_terms=meta["max_query_terms"],
               query_weight=meta["query_weight"],
               tail_budget=meta.get("tail_budget", 1024),
               use_fused_topk=meta.get("use_fused_topk", True))


# --------------------------------------------------------------------------
# registries (one model per language)
# --------------------------------------------------------------------------

def save_registry(path: str, models: Dict[str, SparseModel],
                  extra_meta: Optional[dict] = None) -> None:
    os.makedirs(path, exist_ok=True)
    for lang, model in models.items():
        save_sparse_model(os.path.join(path, lang), model)
    manifest = {
        "format_version": (2 if any(m.index.head_scale is not None
                                    for m in models.values()) else 1),
        "languages": sorted(models),
        "extra": extra_meta or {},
    }
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)


def load_registry(path: str, device: DeviceLike = None
                  ) -> Dict[str, SparseModel]:
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    _check_version(manifest)
    dev = resolve_device(device)
    langs = manifest["languages"]
    # per-language loads are I/O bound: a thread each
    with ThreadPoolExecutor(max_workers=min(8, max(1, len(langs)))) as ex:
        loaded = list(ex.map(
            lambda lang: load_sparse_model(os.path.join(path, lang), dev),
            langs))
    return dict(zip(langs, loaded))


# --------------------------------------------------------------------------
# dense model (encoder params + flat index)
# --------------------------------------------------------------------------

def _flax_param_shapes(cfg) -> dict:
    """The flax ``DualEncoder`` param tree as nested dicts of shapes."""
    D, H = cfg.dim, cfg.heads
    hidden = int(cfg.dim * cfg.mlp_ratio)

    def dense(n_in, n_out):
        return {"kernel": (n_in, n_out), "bias": (n_out,)}

    def ln():
        return {"scale": (D,), "bias": (D,)}

    tree = {"tok_embed": {"embedding": (cfg.vocab_size, D)},
            "pos_embed": (cfg.max_len, D), "ln_out": ln()}
    qkv = {"kernel": (D, H, D // H), "bias": (H, D // H)}
    for i in range(cfg.depth):
        tree[f"block_{i}"] = {
            "ln1": ln(), "ln2": ln(),
            "attn": {"query": dict(qkv), "key": dict(qkv), "value": dict(qkv),
                     "out": {"kernel": (H, D // H, D), "bias": (D,)}},
            "mlp": {"up": dense(D, hidden), "down": dense(hidden, D)}}
    return tree


def _flatten_sorted(tree, prefix=()) -> List[Tuple[tuple, tuple]]:
    """(path, shape) leaves in jax.tree_util's order for nested dicts: the
    keys sorted at every level."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(_flatten_sorted(v, prefix + (k,)))
        else:
            out.append((prefix + (k,), v))
    return out


def _flax_tree_from_state(cfg, sd) -> dict:
    """The inverse of ``encoder_state_from_flax``: a ``DualEncoder``
    state-dict-shaped mapping (its weights, or an AdamW moment of each) as
    the flax param tree (numpy f32, flax shapes)."""
    sd = {k: v.detach().float().cpu().numpy() for k, v in sd.items()}
    shapes = _flax_param_shapes(cfg)
    tree: dict = {"tok_embed": {"embedding": sd["tok_embed.weight"]},
                  "pos_embed": sd["pos_embed"],
                  "ln_out": {"scale": sd["ln_out.weight"],
                             "bias": sd["ln_out.bias"]}}
    for i in range(cfg.depth):
        pre, b = f"blocks.{i}", {}
        for n in ("ln1", "ln2"):
            b[n] = {"scale": sd[f"{pre}.{n}.weight"], "bias": sd[f"{pre}.{n}.bias"]}
        b["attn"] = {}
        for n in ("query", "key", "value", "out"):
            sh = shapes[f"block_{i}"]["attn"][n]
            b["attn"][n] = {
                "kernel": sd[f"{pre}.attn.{n}.weight"].T.reshape(sh["kernel"]),
                "bias": sd[f"{pre}.attn.{n}.bias"].reshape(sh["bias"])}
        b["mlp"] = {n: {"kernel": sd[f"{pre}.mlp.{n}.weight"].T,
                        "bias": sd[f"{pre}.mlp.{n}.bias"]}
                    for n in ("up", "down")}
        tree[f"block_{i}"] = b
    return tree


def _sorted_leaves(cfg, sd) -> List[np.ndarray]:
    """A state-dict-shaped mapping as flax's flattened leaves (f32)."""
    tree = _flax_tree_from_state(cfg, sd)
    out = []
    for p, _ in _flatten_sorted(_flax_param_shapes(cfg)):
        leaf = tree
        for k in p:
            leaf = leaf[k]
        out.append(np.ascontiguousarray(leaf, np.float32))
    return out


def _tree_from_leaves(cfg, leaves, what: str) -> dict:
    """Flattened leaves back into the flax param tree, shapes checked."""
    tree: dict = {}
    for arr, (p, shape) in zip(leaves, _flatten_sorted(_flax_param_shapes(cfg))):
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"{what} leaf {'/'.join(p)} has shape "
                             f"{arr.shape}, expected {shape}")
        node = tree
        for k in p[:-1]:
            node = node.setdefault(k, {})
        node[p[-1]] = arr
    return tree


def save_dense_model(path: str, dense) -> None:
    """Save a ``tdr_torch.models.dense.DenseModel`` (encoder weights, flat
    index, docids)."""
    os.makedirs(path, exist_ok=True)
    leaves = _sorted_leaves(dense.cfg, dense.model.state_dict())
    arrays = {f"p{i}": leaf for i, leaf in enumerate(leaves)}
    dtypes = {k: "float32" for k in arrays}
    np.savez(os.path.join(path, "params.npz"), **arrays)
    emb, emb_dt = _to_numpy_savable(dense.flat.embeddings)
    idx_arrays = {"embeddings": emb}
    if dense.flat.doc_scale is not None:
        idx_arrays["doc_scale"] = dense.flat.doc_scale.cpu().numpy()
    if dense.flat.doc_sq is not None:
        idx_arrays["doc_sq"] = dense.flat.doc_sq.cpu().numpy()
    np.savez(os.path.join(path, "index.npz"), **idx_arrays)
    with open(os.path.join(path, "docids.txt"), "w") as f:
        f.write("\n".join(dense.docids))
    meta = {
        "format_version": 2 if dense.flat.doc_scale is not None else 1,
        "n_leaves": len(arrays),
        "dtypes": dtypes,
        "emb_dtype": emb_dt,
        "n_docs": dense.flat.n_docs,
        "metric": dense.flat.metric,
        "cfg": dataclasses.asdict(dense.cfg),
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)


def load_dense_model(path: str, device: DeviceLike = None):
    """Load a dense checkpoint written by either package: the ``p{i}``
    leaves are placed into the flax param tree by its flatten order and
    carried into a ``DualEncoder`` by ``encoder_state_from_flax``."""
    from tdr_torch.models.dense import DenseModel, flat_index_from_arrays
    from tdr_torch.models.encoder import DualEncoder, encoder_state_from_flax
    from tdr_torch.utils.config import DenseConfig

    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    _check_version(meta)
    dev = resolve_device(device)
    cfg = DenseConfig(**meta["cfg"])
    data = np.load(os.path.join(path, "params.npz"))
    n = len(_flatten_sorted(_flax_param_shapes(cfg)))
    if meta["n_leaves"] != n:
        raise ValueError(f"dense checkpoint has {meta['n_leaves']} leaves, the "
                         f"config's encoder {n}")
    tree = _tree_from_leaves(cfg, [
        _f32_from_saved(data[f"p{i}"], meta["dtypes"][f"p{i}"])
        for i in range(n)], "dense checkpoint")
    model = DualEncoder(cfg)
    model.load_state_dict(encoder_state_from_flax(tree))
    model = model.to(dev).eval()
    idx = np.load(os.path.join(path, "index.npz"))
    flat = flat_index_from_arrays({k: idx[k] for k in idx.files}, meta,
                                  device=dev)
    with open(os.path.join(path, "docids.txt")) as f:
        docids = f.read().splitlines()
    return DenseModel(model=model, cfg=cfg, docids=docids, flat=flat)


# --------------------------------------------------------------------------
# sharded index (one arrays file per shard + shared arrays + manifest)
# --------------------------------------------------------------------------

_SHARDED_STACKED = ("indptr", "postings_doc", "postings_w", "postings_tf",
                    "head_rows", "df_local", "doc_len")
_SHARDED_SHARED = ("head_slot", "idf", "avgdl", "n_valid")
_SHARDED_STATICS = ("n_shards", "n_docs", "n_docs_pad_local", "vocab_size",
                    "tail_pmax", "head_size")


def save_sharded_index(path: str, sindex) -> None:
    """``shared.npz`` (head_slot, idf, avgdl, n_valid), one
    ``shard_NNNN.npz`` per shard (its fields of ``tdr``'s stacked layout)
    and ``manifest.json``: the directory ``tdr``'s ``save_sharded_index``
    writes."""
    os.makedirs(path, exist_ok=True)
    dtypes: Dict[str, str] = {}
    shared: Dict[str, np.ndarray] = {}
    for name in _SHARDED_SHARED:
        shared[name], dtypes[name] = _to_numpy_savable(getattr(sindex, name))
    np.savez(os.path.join(path, "shared.npz"), **shared)
    int8 = sindex.shards[0].head_scale is not None
    stacked = list(_SHARDED_STACKED) + (["head_scale"] if int8 else [])
    for s in range(sindex.n_shards):
        arrays: Dict[str, np.ndarray] = {}
        for name in stacked:
            arrays[name], dtypes[name] = _to_numpy_savable(
                sindex.shard_field(name, s))
        np.savez(os.path.join(path, f"shard_{s:04d}.npz"), **arrays)
    meta = {
        "format_version": 2 if int8 else 1,
        "statics": {k: int(getattr(sindex, k)) for k in _SHARDED_STATICS},
        "dtypes": dtypes,
    }
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(meta, f, indent=2)


def load_sharded_index(path: str, mesh=None, device: DeviceLike = None):
    """A ``ShardedSparseIndex`` from a directory either package wrote, shard
    s on the mesh's data device s (without a mesh, every shard on
    ``device``, by the ``resolve_device`` rule)."""
    from tdr_torch.index.build import IndexStats, SparseIndex, _tensor_from_saved
    from tdr_torch.parallel.sharded import ShardedSparseIndex

    with open(os.path.join(path, "manifest.json")) as f:
        meta = json.load(f)
    _check_version(meta)
    dtypes = meta["dtypes"]
    statics = {k: int(meta["statics"][k]) for k in _SHARDED_STATICS}
    S = statics["n_shards"]
    if mesh is not None:
        devs = mesh.axis_devices("data")
        if len(devs) != S:
            raise ValueError(f"{S} shards on a data axis of {len(devs)}")
    else:
        devs = [resolve_device(device)] * S
    # read whole before the threads start: one NpzFile is one zip handle,
    # which concurrent reads corrupt
    with np.load(os.path.join(path, "shared.npz")) as data:
        shared_np = {k: data[k] for k in data.files}
    n_valid = torch.from_numpy(np.asarray(shared_np["n_valid"], np.int32))
    stacked = list(_SHARDED_STACKED) + (
        ["head_scale"] if "head_scale" in dtypes else [])

    def _load_shard(s):
        dev = devs[s]
        with np.load(os.path.join(path, f"shard_{s:04d}.npz")) as data:
            a = {name: _tensor_from_saved(data[name], dtypes[name], dev)
                 for name in stacked}
        sh = {name: _tensor_from_saved(shared_np[name], dtypes[name], dev)
              for name in ("head_slot", "idf", "avgdl")}
        return SparseIndex(
            indptr=a["indptr"], postings_doc=a["postings_doc"],
            postings_w=a["postings_w"], postings_tf=a["postings_tf"],
            head_slot=sh["head_slot"], head_rows=a["head_rows"],
            stats=IndexStats(df=a["df_local"], idf=sh["idf"],
                             doc_len=a["doc_len"], avgdl=sh["avgdl"]),
            head_scale=a.get("head_scale"), n_docs=int(n_valid[s]),
            n_docs_pad=statics["n_docs_pad_local"],
            vocab_size=statics["vocab_size"], tail_pmax=statics["tail_pmax"],
            head_size=statics["head_size"])

    # shard loads are I/O bound: a thread each
    with ThreadPoolExecutor(max_workers=min(8, S)) as ex:
        shards = list(ex.map(_load_shard, range(S)))
    return ShardedSparseIndex(shards=shards, n_valid=n_valid, **statics)


# --------------------------------------------------------------------------
# training state (params + AdamW moments + step) for resume
# --------------------------------------------------------------------------

def save_train_state(path: str, state) -> None:
    """Checkpoint a ``tdr_torch.train.TrainState`` in ``tdr``'s layout: the
    leaves of jax's flattened ``TrainState(params, opt_state, step)`` as
    ``l{i}`` in ``train_state.npz`` — the params (flax's sorted-key order),
    optax's ``count``, the ``mu`` leaves, the ``nu`` leaves, the step — so
    that either package resumes from the other's file.  A
    ``ShardedTrainState`` is gathered first (the file is the same)."""
    from tdr_torch.train.contrastive import (ShardedTrainState, adam_moments,
                                             unshard_train_state)

    if isinstance(state, ShardedTrainState):
        state = unshard_train_state(state)
    os.makedirs(path, exist_ok=True)
    cfg = state.model.cfg
    count, mu, nu = adam_moments(state)
    flat = (_sorted_leaves(cfg, state.model.state_dict())
            + [np.asarray(count, np.int32)] + _sorted_leaves(cfg, mu)
            + _sorted_leaves(cfg, nu) + [np.asarray(state.step, np.int32)])
    arrays = {f"l{i}": leaf for i, leaf in enumerate(flat)}
    np.savez(os.path.join(path, "train_state.npz"), **arrays)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"format_version": FORMAT_VERSION, "n_leaves": len(flat),
                   "dtypes": {k: str(v.dtype) for k, v in arrays.items()}}, f)


def load_train_state(path: str, template):
    """Restore into ``template`` (a fresh ``TrainState`` from
    ``create_train_state`` with the same config; its learning rate and
    weight decay are kept) and return it.  A ``ShardedTrainState``
    template gives a new one on its mesh: the file is loaded whole, then
    sharded again."""
    from tdr_torch.models.encoder import encoder_state_from_flax
    from tdr_torch.train.contrastive import (ShardedTrainState,
                                             load_adam_moments,
                                             shard_train_state,
                                             unshard_train_state)

    if isinstance(template, ShardedTrainState):
        whole = load_train_state(path, unshard_train_state(template))
        return shard_train_state(template.mesh, whole)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    _check_version(meta)
    cfg = template.model.cfg
    n = len(_flatten_sorted(_flax_param_shapes(cfg)))
    if meta["n_leaves"] != 3 * n + 2:
        raise ValueError(
            f"train state has {meta['n_leaves']} leaves, template has "
            f"{3 * n + 2} — config mismatch")
    data = np.load(os.path.join(path, "train_state.npz"))
    leaf = [data[f"l{i}"] for i in range(meta["n_leaves"])]

    def state_dict(lo: int, what: str):
        f32 = [_f32_from_saved(a, meta["dtypes"][f"l{lo + i}"])
               for i, a in enumerate(leaf[lo:lo + n])]
        return encoder_state_from_flax(_tree_from_leaves(cfg, f32, what))

    with torch.no_grad():
        template.model.load_state_dict(state_dict(0, "train state param"))
    load_adam_moments(template.optimizer, template.model.named_parameters(),
                      int(leaf[n]),
                      state_dict(n + 1, "train state mu"),
                      state_dict(2 * n + 1, "train state nu"))
    template.step = int(leaf[3 * n + 1])
    return template


# --------------------------------------------------------------------------
# segmented (live-update) models
# --------------------------------------------------------------------------

def save_segmented(path: str, seg) -> None:
    """Persist a ``SegmentedBM25``: the main segment as a sparse checkpoint,
    the delta's source token lists and the tombstones as JSON (the delta
    index is rebuilt at load).  Written to a dot-prefixed sibling and
    swapped in by renames; ``recover_segmented_dir`` repairs a swap cut
    between its two renames."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    base = os.path.basename(path)
    tmp = os.path.join(parent, f".{base}.tmp-{os.getpid()}")
    _write_segmented(tmp, seg)
    old = os.path.join(parent, f".{base}.old-{os.getpid()}")
    if os.path.exists(path):
        os.rename(path, old)
    os.rename(tmp, path)
    if os.path.exists(old):
        shutil.rmtree(old, ignore_errors=True)


def recover_segmented_dir(parent: str) -> None:
    """Rename a parked ``.<name>.old-*`` back where ``<name>`` is missing;
    delete leftover ``.tmp-*`` and orphaned ``.old-*`` directories."""
    if not os.path.isdir(parent):
        return
    for entry in sorted(os.listdir(parent)):
        m = re.fullmatch(r"\.(.+)\.old-\d+", entry)
        if m:
            target = os.path.join(parent, m.group(1))
            if not os.path.exists(target):
                os.rename(os.path.join(parent, entry), target)
            else:
                shutil.rmtree(os.path.join(parent, entry), ignore_errors=True)
        elif re.fullmatch(r"\..+\.tmp-\d+", entry):
            shutil.rmtree(os.path.join(parent, entry), ignore_errors=True)


def _write_segmented(path: str, seg) -> None:
    os.makedirs(path, exist_ok=True)
    save_sparse_model(os.path.join(path, "main"), seg.main)
    state = {
        "format_version": FORMAT_VERSION,
        "lang": seg.lang,
        "bm25": dataclasses.asdict(seg.bm25),
        "index_cfg": dataclasses.asdict(seg.index_cfg),
        "delta_toks": seg._delta_toks,
        "delta_ids": seg._delta_ids,
        "deleted": sorted(seg._deleted),
    }
    with open(os.path.join(path, "segments.json"), "w") as f:
        json.dump(state, f)


def load_segmented(path: str, device: DeviceLike = None):
    from tdr_torch.rank.segmented import SegmentedBM25
    from tdr_torch.utils.config import BM25Config, IndexConfig

    with open(os.path.join(path, "segments.json")) as f:
        state = json.load(f)
    _check_version(state)
    seg = SegmentedBM25(
        main=load_sparse_model(os.path.join(path, "main"), device),
        lang=state["lang"], bm25=BM25Config(**state["bm25"]),
        index_cfg=IndexConfig(**state["index_cfg"]))
    if state["delta_ids"]:
        # replaying the adds rebuilds the positional shadows
        seg.add_documents(state["delta_toks"], state["delta_ids"])
    # the persisted set holds ids deleted and not re-added since
    if state["deleted"]:
        seg.delete_documents(state["deleted"])
    return seg
