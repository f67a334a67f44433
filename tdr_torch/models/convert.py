"""HF BERT weights for the port: the port of ``tdr/models/convert.py``.

The reference's strongest dense re-ranker is the pretrained
``paraphrase-multilingual-MiniLM-L12-v2`` sentence-transformer
(team_run1.py:211-214, mean-pooled last_hidden_state): a BERT-architecture
model that the pre-LN ``DualEncoder`` cannot load.  This module provides:

* ``BertEncoder`` — the HF ``BertModel`` encoder stack (post-LN residuals,
  learned absolute positions, token-type embeddings) with
  sentence-transformers pooling (masked mean + L2 norm, team_run1.py:231-239).
  Its submodules carry HF's names (``embeddings.word_embeddings``,
  ``encoder.layer.{i}.attention.self.query``, ...), so an HF state dict
  with its prefixes stripped loads with ``load_state_dict(strict=True)``;
* ``convert_hf_bert`` — an HF or sentence-transformers state dict → this
  module's state dict;
* ``bert_state_from_flax`` — ``tdr``'s flax ``BertEncoder`` params → this
  module's state dict, so the two forwards can be compared on one set of
  weights;
* ``load_sentence_transformer`` — a local checkpoint directory
  (``pytorch_model.bin`` or ``model.safetensors``, read with the port's own
  reader: no ``safetensors`` package needed) → a ``BertEncoder``;
* ``minilm_l12_config`` — the real model's dimensions.

``BertEncoder`` computes what the flax module computes, at its rounding
points:

* embeddings: f32 word + position[:L] + token-type row 0, an f32 LayerNorm
  (flax's fast variance, epsilon 1e-12), then the compute dtype;
* query/key/value and the output projection are ``Dense`` in the compute
  dtype (the product rounded to it, the bias added in it);
* the attention scores accumulate the compute-dtype Q·K products in f32
  (``preferred_element_type``) and are divided by sqrt(head_dim) after the
  product, in f32; the additive key mask is -1e9; the softmax is taken in
  f32 and cast to the compute dtype; the context ``att @ v`` accumulates in
  f32 and is cast to the compute dtype;
* the residuals are post-LN, each LayerNorm f32 in and out, so from layer
  0's first LayerNorm on the residual stream is f32;
* the MLP's GELU is exact (erf);
* pooling clamps the mask count at 1e-9 and the L2 norm at 1e-12.

An f32 encoder multiplies in full IEEE f32 whatever the caller's TF32
setting (``ops.precision.ieee_f32``).  The attention is plain torch code:
``tdr`` computes it in XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import json
import math
import os
import struct
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tdr_torch.models.encoder import LayerNorm, _dense
from tdr_torch.ops.precision import ieee_f32
from tdr_torch.utils.device import DeviceLike, resolve_device

_MASK_ADD = -1e9          # flax module's additive key mask
_PREFIXES = ("0.auto_model.", "auto_model.", "bert.")


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    dim: int = 384
    depth: int = 12
    heads: int = 12
    mlp_hidden: int = 1536
    max_len: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12


def minilm_l12_config() -> BertConfig:
    """paraphrase-multilingual-MiniLM-L12-v2 (BertModel architecture over
    the XLM-R vocabulary; sentence-transformers config.json)."""
    return BertConfig(vocab_size=250037, dim=384, depth=12, heads=12,
                      mlp_hidden=1536, max_len=512, type_vocab_size=2)


class _Embeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.dim)
        self.position_embeddings = nn.Embedding(cfg.max_len, cfg.dim)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, cfg.dim)
        self.LayerNorm = LayerNorm(cfg.dim, cfg.layer_norm_eps)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        L = ids.shape[1]
        x = (self.word_embeddings(ids.long())
             + self.position_embeddings.weight[None, :L]
             + self.token_type_embeddings.weight[0][None, None])
        return self.LayerNorm(x)


class _SelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, dtype: torch.dtype):
        super().__init__()
        self.heads = cfg.heads
        self.dtype = dtype
        self.query = nn.Linear(cfg.dim, cfg.dim)
        self.key = nn.Linear(cfg.dim, cfg.dim)
        self.value = nn.Linear(cfg.dim, cfg.dim)

    def forward(self, x: torch.Tensor, additive: torch.Tensor) -> torch.Tensor:
        """(B, L, D) → the (B, L, D) context in the compute dtype."""
        B, L, D = x.shape
        H = self.heads
        hd = D // H

        def heads(lin):
            return _dense(x, lin, self.dtype).view(B, L, H, hd).transpose(1, 2)

        q, k, v = heads(self.query), heads(self.key), heads(self.value)
        # compute-dtype products accumulated in f32 (exact products for
        # bf16 operands), scaled after the product
        att = q.float() @ k.float().transpose(-1, -2) / math.sqrt(hd)
        att = torch.softmax(att + additive, dim=-1).to(self.dtype)
        ctx = (att.float() @ v.float()).to(self.dtype)
        return ctx.transpose(1, 2).reshape(B, L, D)


class _SelfOutput(nn.Module):
    def __init__(self, cfg: BertConfig, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.dense = nn.Linear(cfg.dim, cfg.dim)
        self.LayerNorm = LayerNorm(cfg.dim, cfg.layer_norm_eps)

    def forward(self, ctx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(x + _dense(ctx, self.dense, self.dtype))


class _Attention(nn.Module):
    def __init__(self, cfg: BertConfig, dtype: torch.dtype):
        super().__init__()
        self.self = _SelfAttention(cfg, dtype)
        self.output = _SelfOutput(cfg, dtype)

    def forward(self, x: torch.Tensor, additive: torch.Tensor) -> torch.Tensor:
        return self.output(self.self(x, additive), x)


class _Intermediate(nn.Module):
    def __init__(self, cfg: BertConfig, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.dense = nn.Linear(cfg.dim, cfg.mlp_hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(_dense(x, self.dense, self.dtype), approximate="none")


class _Output(nn.Module):
    def __init__(self, cfg: BertConfig, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.dense = nn.Linear(cfg.mlp_hidden, cfg.dim)
        self.LayerNorm = LayerNorm(cfg.dim, cfg.layer_norm_eps)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(x + _dense(h, self.dense, self.dtype))


class _Layer(nn.Module):
    def __init__(self, cfg: BertConfig, dtype: torch.dtype):
        super().__init__()
        self.attention = _Attention(cfg, dtype)
        self.intermediate = _Intermediate(cfg, dtype)
        self.output = _Output(cfg, dtype)

    def forward(self, x: torch.Tensor, additive: torch.Tensor) -> torch.Tensor:
        x = self.attention(x, additive)                 # post-LN, f32
        return self.output(self.intermediate(x), x)


class _Stack(nn.Module):
    def __init__(self, cfg: BertConfig, dtype: torch.dtype):
        super().__init__()
        self.layer = nn.ModuleList(_Layer(cfg, dtype) for _ in range(cfg.depth))


class BertEncoder(nn.Module):
    """HF BertModel encoder + sentence-transformers pooling: (B, L) ids and
    mask → masked-mean-pooled, L2-normalized (B, dim) f32 embeddings.
    ``dtype`` is the compute dtype of the dense layers (f32 by default, as
    in ``tdr``)."""

    def __init__(self, cfg: BertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Stack(cfg, dtype)

    @ieee_f32()
    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        L = ids.shape[1]
        if L > self.cfg.max_len:
            raise ValueError(f"sequence length {L} exceeds the position "
                             f"table's {self.cfg.max_len}")
        x = self.embeddings(ids).to(self.dtype)
        additive = torch.where(mask[:, None, None, :] > 0, 0.0,
                               _MASK_ADD).float()
        for layer in self.encoder.layer:
            x = layer(x, additive)
        m = mask[..., None].float()
        pooled = (x.float() * m).sum(dim=1) / m.sum(dim=1).clamp_min(1e-9)
        norm = torch.sqrt((pooled * pooled).sum(dim=-1, keepdim=True))
        return pooled / norm.clamp_min(1e-12)


def _state_keys(cfg: BertConfig) -> List[str]:
    """The parameter names of ``BertEncoder(cfg)``, as HF ``BertModel``
    names them."""
    keys = [f"embeddings.{n}.weight" for n in (
        "word_embeddings", "position_embeddings", "token_type_embeddings")]
    keys += ["embeddings.LayerNorm.weight", "embeddings.LayerNorm.bias"]
    for i in range(cfg.depth):
        for sub in ("attention.self.query", "attention.self.key",
                    "attention.self.value", "attention.output.dense",
                    "attention.output.LayerNorm", "intermediate.dense",
                    "output.dense", "output.LayerNorm"):
            keys += [f"encoder.layer.{i}.{sub}.weight",
                     f"encoder.layer.{i}.{sub}.bias"]
    return keys


def _f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).clone()
    return torch.from_numpy(np.array(x, dtype=np.float32))


def convert_hf_bert(state_dict: Mapping[str, Any],
                    cfg: BertConfig) -> Dict[str, torch.Tensor]:
    """HF ``BertModel.state_dict()`` (or a sentence-transformers one, keys
    prefixed ``0.auto_model.`` / ``auto_model.`` / ``bert.``) → the state
    dict of :class:`BertEncoder`, f32 on the CPU.  Keys the encoder has no
    use for (the pooler, the ``position_ids`` buffer) are left out."""
    sd: Dict[str, Any] = {}
    for k, v in state_dict.items():
        for pre in _PREFIXES:
            if k.startswith(pre):
                k = k[len(pre):]
                break
        sd[k] = v
    return {k: _f32(sd[k]) for k in _state_keys(cfg)}


def bert_state_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """``tdr``'s flax ``BertEncoder`` param tree (nested dicts of numpy
    arrays) → the state dict of :class:`BertEncoder`.  The query/key/value
    kernels are (in, heads, head_dim), the output kernel (heads, head_dim,
    dim) and a ``Dense`` kernel (in, out); an ``nn.Linear`` weight is
    (out, in)."""

    def linear(prefix: str, p: Mapping, n_in: int = 1) -> None:
        k = np.asarray(p["kernel"], np.float32)
        k = k.reshape(int(np.prod(k.shape[:n_in])), -1)          # (in, out)
        state[f"{prefix}.weight"] = _f32(k.T)
        state[f"{prefix}.bias"] = _f32(np.asarray(p["bias"]).reshape(-1))

    def ln(prefix: str, p: Mapping) -> None:
        state[f"{prefix}.weight"] = _f32(p["scale"])
        state[f"{prefix}.bias"] = _f32(p["bias"])

    state: Dict[str, torch.Tensor] = {
        "embeddings.word_embeddings.weight":
            _f32(params["word_embeddings"]["embedding"]),
        "embeddings.position_embeddings.weight":
            _f32(params["position_embeddings"]),
        "embeddings.token_type_embeddings.weight":
            _f32(params["token_type_embeddings"]),
    }
    ln("embeddings.LayerNorm", params["embed_ln"])
    i = 0
    while f"layer_{i}" in params:
        p, e = params[f"layer_{i}"], f"encoder.layer.{i}"
        for name in ("query", "key", "value"):
            linear(f"{e}.attention.self.{name}", p["attn"][name])
        linear(f"{e}.attention.output.dense", p["attn"]["out"], n_in=2)
        ln(f"{e}.attention.output.LayerNorm", p["attn_ln"])
        linear(f"{e}.intermediate.dense", p["mlp_up"])
        linear(f"{e}.output.dense", p["mlp_down"])
        ln(f"{e}.output.LayerNorm", p["mlp_ln"])
        i += 1
    return state


def init_bert_encoder(cfg: BertConfig, seed: int = 0,
                      dtype: torch.dtype = torch.float32,
                      device: DeviceLike = None) -> BertEncoder:
    """A ``BertEncoder`` with the flax init's distributions, drawn from a
    ``torch.Generator`` seeded with ``seed`` on the CPU (one seed gives the
    same weights on every device): normal(0.02) embeddings, xavier-uniform
    kernels, zero biases, unit LayerNorm scales.  For runs at the real
    widths without the pretrained checkpoint."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    model = BertEncoder(cfg, dtype)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Embedding):
                mod.weight.normal_(0.0, 0.02, generator=gen)
            elif isinstance(mod, nn.Linear):
                nn.init.xavier_uniform_(mod.weight, generator=gen)
                mod.bias.zero_()
    return model.to(dev).eval()


_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32,
              "F16": torch.float16, "BF16": torch.bfloat16,
              "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
              "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file → {name: CPU tensor}: an 8-byte
    little-endian header length, a JSON header of (dtype, shape,
    data_offsets) per tensor, then the raw little-endian data."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dt = _ST_DTYPES[info["dtype"]]
        lo, hi = info["data_offsets"]
        if hi == lo:
            out[name] = torch.empty(info["shape"], dtype=dt)
            continue
        count = (hi - lo) // dt.itemsize
        out[name] = torch.frombuffer(data, dtype=dt, count=count,
                                     offset=lo).reshape(info["shape"])
    return out


def load_sentence_transformer(model_dir: str,
                              cfg: Optional[BertConfig] = None,
                              dtype: torch.dtype = torch.float32,
                              device: DeviceLike = None) -> BertEncoder:
    """A local sentence-transformers checkpoint directory → a
    ``BertEncoder`` on ``device``.  Reads ``model.safetensors`` (the port's
    own reader) or else ``pytorch_model.bin`` (``torch.load`` with
    ``weights_only=True``); no network."""
    cfg = cfg or minilm_l12_config()
    dev = resolve_device(device)
    st = os.path.join(model_dir, "model.safetensors")
    pt = os.path.join(model_dir, "pytorch_model.bin")
    if os.path.exists(st):
        sd = read_safetensors(st)
    elif os.path.exists(pt):
        sd = torch.load(pt, map_location="cpu", weights_only=True)
    else:
        raise FileNotFoundError(f"no weights in {model_dir}")
    model = BertEncoder(cfg, dtype)
    model.load_state_dict(convert_hf_bert(sd, cfg), strict=True)
    return model.to(dev).eval()
