"""Dense multilingual encoder: the port of ``tdr/models/encoder.py``.

A MiniLM-class pre-LN transformer over hashed token ids, mean-pooled and
L2-normalized.  It computes what the flax ``DualEncoder`` computes, at the
same rounding points:

* parameters are kept in f32 and cast to the compute dtype (bf16 by default)
  at each use, as flax's ``dtype=`` does;
* LayerNorm runs in f32 with epsilon 1e-6 and flax's fast variance
  (``E[x²] - E[x]²``, clamped at 0), and returns f32
  (``ops.layer_norm.layer_norm``);
* a dense layer rounds its product to the compute dtype, then adds the bias
  in that dtype;
* attention divides the *query* by ``sqrt(head_dim)`` in the compute dtype,
  masks with ``finfo(dtype).min``, padded query rows too, and takes the
  softmax in the compute dtype (``ops.attention.attend``);
* GELU is the tanh approximation (flax's ``nn.gelu`` default);
* mean pooling and the L2 normalization run in f32;
* an f32 encoder (``cfg.dtype="float32"``) multiplies in full IEEE f32,
  whatever the caller's TF32 setting (``ops.precision.ieee_f32``).

The JAX package computes LayerNorm and attention in XLA, outside any Pallas
kernel.  ``encoder_state_from_flax`` carries flax parameters across, so the
two forwards can be compared on the same weights.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tdr_torch.ops.attention import attend
from tdr_torch.ops.layer_norm import EPS, layer_norm
from tdr_torch.ops.precision import ieee_f32
from tdr_torch.utils.config import DenseConfig
from tdr_torch.utils.device import DeviceLike, resolve_device

Params = Mapping[str, torch.Tensor]


def _dtype(cfg: DenseConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def product(x: torch.Tensor, weight: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=...)``'s product, rounded to ``dtype``."""
    return F.linear(x.to(dtype), weight.to(dtype))


def linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=...)``: the product rounded to ``dtype``, then the
    bias added in ``dtype``."""
    return product(x, weight, dtype) + bias.to(dtype)


def _dense(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    return linear(x, lin.weight, lin.bias, dtype)


def project_heads(y: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  heads: int, dtype: torch.dtype) -> torch.Tensor:
    """A query, key or value projection as (B, heads, L, head_dim)."""
    B, L, _ = y.shape
    return linear(y, weight, bias, dtype).view(B, L, heads, -1).transpose(1, 2)


def mlp_hidden(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """The MLP's up projection and tanh GELU."""
    return F.gelu(linear(x, weight, bias, dtype), approximate="tanh")


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: f32 statistics with the fast
    variance, epsilon ``eps`` (flax's 1e-6 by default; BERT uses 1e-12),
    f32 output."""

    def __init__(self, dim: int, eps: float = EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class MlpBlock(nn.Module):
    """The MLP's parameters (``encode_shards`` runs it)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.up = nn.Linear(dim, hidden)
        self.down = nn.Linear(hidden, dim)


class Attention(nn.Module):
    """flax ``MultiHeadDotProductAttention``'s parameters (self-attention,
    no dropout; ``encode_shards`` runs it)."""

    def __init__(self, dim: int):
        super().__init__()
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)


class EncoderBlock(nn.Module):
    """One pre-LN block's parameters (``encode_shards`` runs it)."""

    def __init__(self, dim: int, mlp_hidden: int):
        super().__init__()
        self.ln1 = LayerNorm(dim)
        self.attn = Attention(dim)
        self.ln2 = LayerNorm(dim)
        self.mlp = MlpBlock(dim, mlp_hidden)


def embed(ids: torch.Tensor, table: torch.Tensor, pos: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """Token rows gathered in f32, then cast, plus the positions in
    ``dtype``."""
    L = ids.shape[1]
    return (F.embedding(ids.long(), table).to(dtype)
            + pos[None, :L].to(dtype))


def pool(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean pooling over the valid tokens, then the L2 normalization (f32)."""
    m = mask[..., None].float()
    pooled = (x * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
    norm = torch.sqrt((pooled * pooled).sum(dim=-1, keepdim=True))
    return pooled / norm.clamp_min(1e-6)


def encode_shards(shards: Sequence[Params], cfg: DenseConfig,
                  ids: Sequence[torch.Tensor],
                  mask: Sequence[torch.Tensor]) -> torch.Tensor:
    """The encoder's forward over model shards of its weights, (B, dim) f32
    on shard 0's device.  ``shards[m]`` maps state-dict names to model
    shard m's parameters: its heads of the q/k/v/out projections and its
    slice of the MLP's hidden axis (``parallel.train.PARAM_SPLITS``), the
    rest whole; ``ids[m]`` and ``mask[m]`` are its copy of the rows.  Each
    shard carries its own residual stream; the partial products of the
    attention's output projection and of ``mlp.down`` are summed over the
    shards (Megatron-style).  With one shard this is ``DualEncoder``'s
    forward."""
    # imported here: tdr_torch.parallel's __init__ imports this package
    from tdr_torch.parallel.mesh import _copy, psum

    def residual(x, parts, bias):
        total = psum(parts, x[0].device)
        return [xm + (_copy(total, xm.device) + p[bias].to(dtype))
                for xm, p in zip(x, shards)]

    n = len(shards)
    dtype = _dtype(cfg)
    heads = cfg.heads // n
    x = [embed(i, p["tok_embed.weight"], p["pos_embed"], dtype)
         for i, p in zip(ids, shards)]
    valid = [mk > 0 for mk in mask]
    for b in range(cfg.depth):
        pre = f"blocks.{b}."
        parts = []
        for m, p in enumerate(shards):
            y = layer_norm(x[m], p[pre + "ln1.weight"], p[pre + "ln1.bias"])
            # q/k/v biases are replicated: each shard adds its heads' part
            q, k, v = (project_heads(
                y, p[f"{pre}attn.{w}.weight"],
                torch.chunk(p[f"{pre}attn.{w}.bias"], n)[m], heads, dtype)
                for w in ("query", "key", "value"))
            parts.append(product(attend(q, k, v, valid[m], dtype),
                                 p[pre + "attn.out.weight"], dtype))
        x = residual(x, parts, pre + "attn.out.bias")
        parts = []
        for m, p in enumerate(shards):
            y = layer_norm(x[m], p[pre + "ln2.weight"], p[pre + "ln2.bias"])
            h = mlp_hidden(y, p[pre + "mlp.up.weight"], p[pre + "mlp.up.bias"],
                           dtype)
            parts.append(product(h, p[pre + "mlp.down.weight"], dtype))
        x = residual(x, parts, pre + "mlp.down.bias")
    p = shards[0]
    return pool(layer_norm(x[0], p["ln_out.weight"], p["ln_out.bias"]),
                mask[0])


class DualEncoder(nn.Module):
    """Shared-weight text encoder producing L2-normalized embeddings."""

    def __init__(self, cfg: DenseConfig):
        super().__init__()
        self.cfg = cfg
        self.tok_embed = nn.Embedding(cfg.vocab_size, cfg.dim)
        self.pos_embed = nn.Parameter(torch.zeros(cfg.max_len, cfg.dim))
        hidden = int(cfg.dim * cfg.mlp_ratio)
        self.blocks = nn.ModuleList(
            EncoderBlock(cfg.dim, hidden) for _ in range(cfg.depth))
        self.ln_out = LayerNorm(cfg.dim)

    @ieee_f32()
    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return encode_shards([dict(self.named_parameters())], self.cfg,
                             [ids], [mask])


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
    ``convert.BertEncoder``, ``mla_moe.MlaMoeEncoder``)."""
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
