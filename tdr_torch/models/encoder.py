"""Dense multilingual encoder: the port of ``tdr/models/encoder.py``.

A MiniLM-class pre-LN transformer over hashed token ids, mean-pooled and
L2-normalized.  It computes what the flax ``DualEncoder`` computes, at the
same rounding points:

* parameters are kept in f32 and cast to the compute dtype (bf16 by default)
  at each use, as flax's ``dtype=`` does;
* LayerNorm runs in f32 with epsilon 1e-6 and flax's fast variance
  (``E[x²] - E[x]²``, clamped at 0), and returns f32;
* a dense layer rounds its product to the compute dtype, then adds the bias
  in that dtype;
* attention divides the *query* by ``sqrt(head_dim)`` in the compute dtype,
  masks with ``finfo(dtype).min`` (not ``-inf``: a padded query row, whose
  keys are all masked, then gets a uniform softmax instead of NaN, and NaN
  would survive the mean pooling), and takes the softmax in the compute
  dtype;
* GELU is the tanh approximation (flax's ``nn.gelu`` default);
* mean pooling and the L2 normalization run in f32;
* an f32 encoder (``cfg.dtype="float32"``) multiplies in full IEEE f32,
  whatever the caller's TF32 setting (``ops.precision.ieee_f32``).

The attention is plain torch code: the JAX package computes it in XLA, outside
any Pallas kernel.  ``encoder_state_from_flax`` carries flax parameters
across, so the two forwards can be compared on the same weights.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tdr_torch.ops.precision import ieee_f32
from tdr_torch.utils.config import DenseConfig
from tdr_torch.utils.device import DeviceLike, resolve_device

_LN_EPS = 1e-6


def _dtype(cfg: DenseConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _dense(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=...)``: the product rounded to ``dtype``, then the
    bias added in ``dtype``."""
    return F.linear(x.to(dtype), lin.weight.to(dtype)) + lin.bias.to(dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: f32 statistics with the fast
    variance, epsilon ``eps`` (flax's 1e-6 by default; BERT uses 1e-12),
    f32 output."""

    def __init__(self, dim: int, eps: float = _LN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mu = x.mean(dim=-1, keepdim=True)
        var = ((x * x).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mu) * mul + self.bias


class MlpBlock(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.up = nn.Linear(dim, hidden)
        self.down = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(_dense(x, self.up, self.dtype), approximate="tanh")
        return _dense(h, self.down, self.dtype)


class Attention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (self-attention, no dropout)."""

    def __init__(self, dim: int, heads: int, dtype: torch.dtype):
        super().__init__()
        self.heads = heads
        self.dtype = dtype
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        B, L, D = y.shape
        H = self.heads
        Dh = D // H

        def heads(lin):
            return _dense(y, lin, self.dtype).view(B, L, H, Dh).transpose(1, 2)

        q, k, v = heads(self.query), heads(self.key), heads(self.value)
        q = q / torch.tensor(math.sqrt(Dh)).to(self.dtype)
        w = q @ k.transpose(-1, -2)                         # (B, H, L, L)
        w = w.masked_fill(~mask, torch.finfo(self.dtype).min)
        w = torch.softmax(w, dim=-1)
        o = (w @ v).transpose(1, 2).reshape(B, L, D)
        return _dense(o, self.out, self.dtype)


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_hidden: int,
                 dtype: torch.dtype):
        super().__init__()
        self.ln1 = LayerNorm(dim)
        self.attn = Attention(dim, heads, dtype)
        self.ln2 = LayerNorm(dim)
        self.mlp = MlpBlock(dim, mlp_hidden, dtype)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), mask)
        return x + self.mlp(self.ln2(x))


class DualEncoder(nn.Module):
    """Shared-weight text encoder producing L2-normalized embeddings."""

    def __init__(self, cfg: DenseConfig):
        super().__init__()
        self.cfg = cfg
        self.dtype = _dtype(cfg)
        self.tok_embed = nn.Embedding(cfg.vocab_size, cfg.dim)
        self.pos_embed = nn.Parameter(torch.zeros(cfg.max_len, cfg.dim))
        hidden = int(cfg.dim * cfg.mlp_ratio)
        self.blocks = nn.ModuleList(
            EncoderBlock(cfg.dim, cfg.heads, hidden, self.dtype)
            for _ in range(cfg.depth))
        self.ln_out = LayerNorm(cfg.dim)

    @ieee_f32()
    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        L = ids.shape[1]
        x = (self.tok_embed(ids.long()).to(self.dtype)
             + self.pos_embed[None, :L].to(self.dtype))
        valid = mask > 0
        # flax make_attention_mask(mask, mask): padded query rows masked too
        attn_mask = valid[:, None, :, None] & valid[:, None, None, :]
        for blk in self.blocks:
            x = blk(x, attn_mask)
        x = self.ln_out(x)
        m = mask[..., None].float()
        pooled = (x * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
        norm = torch.sqrt((pooled * pooled).sum(dim=-1, keepdim=True))
        return pooled / norm.clamp_min(1e-6)


def init_encoder(cfg: DenseConfig, seed: int = 0,
                 device: DeviceLike = None) -> DualEncoder:
    """A ``DualEncoder`` with the flax init's distributions, drawn from a
    ``torch.Generator`` seeded with ``seed`` on the CPU (so one seed gives
    the same weights on every device): normal(0.02) embeddings,
    xavier-uniform kernels, zero biases, unit LayerNorm scales.  The values
    differ from flax's, whose random bits torch cannot reproduce."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    model = DualEncoder(cfg)
    with torch.no_grad():
        model.tok_embed.weight.normal_(0.0, 0.02, generator=gen)
        model.pos_embed.normal_(0.0, 0.02, generator=gen)
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                nn.init.xavier_uniform_(mod.weight, generator=gen)
                mod.bias.zero_()
    return model.to(dev).eval()


def module_device(model: nn.Module) -> torch.device:
    """The device of an encoder's parameters (any encoder module)."""
    return next(model.parameters()).device


def encode(model: nn.Module, ids, mask) -> torch.Tensor:
    """(B, L) ids and mask (numpy or tensors) → (B, dim) f32 embeddings on
    the model's device, for any encoder module (``DualEncoder``,
    ``convert.BertEncoder``)."""
    dev = module_device(model)
    with torch.inference_mode():
        return model(torch.as_tensor(ids, device=dev),
                     torch.as_tensor(mask, device=dev))


def encoder_state_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The flax ``DualEncoder`` param tree (nested dicts of numpy arrays, as
    ``flax.linen.meta.unbox`` + ``np.asarray`` give it) → this module's
    ``state_dict``.  A flax ``Dense`` kernel is (in, out) and an
    ``nn.Linear`` weight (out, in); the attention kernels are (D, H, Dh) for
    query/key/value and (H, Dh, D) for the output, flattened to (D, D)."""

    def t(x) -> torch.Tensor:
        return torch.from_numpy(np.array(x, dtype=np.float32))

    def dense(prefix: str, p: Mapping, n_in: int = 1):
        k = np.asarray(p["kernel"], np.float32)
        k = k.reshape(int(np.prod(k.shape[:n_in])), -1)        # (in, out)
        state[f"{prefix}.weight"] = t(k.T)
        state[f"{prefix}.bias"] = t(np.asarray(p["bias"]).reshape(-1))

    state: Dict[str, torch.Tensor] = {
        "tok_embed.weight": t(params["tok_embed"]["embedding"]),
        "pos_embed": t(params["pos_embed"]),
        "ln_out.weight": t(params["ln_out"]["scale"]),
        "ln_out.bias": t(params["ln_out"]["bias"]),
    }
    i = 0
    while f"block_{i}" in params:
        b = params[f"block_{i}"]
        pre = f"blocks.{i}"
        for ln in ("ln1", "ln2"):
            state[f"{pre}.{ln}.weight"] = t(b[ln]["scale"])
            state[f"{pre}.{ln}.bias"] = t(b[ln]["bias"])
        for name in ("query", "key", "value"):
            dense(f"{pre}.attn.{name}", b["attn"][name])
        dense(f"{pre}.attn.out", b["attn"]["out"], n_in=2)
        for name in ("up", "down"):
            dense(f"{pre}.mlp.{name}", b["mlp"][name])
        i += 1
    return state
