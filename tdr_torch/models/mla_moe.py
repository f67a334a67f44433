"""DeepSeek-V2's block as a dense retrieval encoder: multi-head latent
attention (MLA) and routed experts (DeepSeek-V2, arXiv:2405.04434; the
``deepseek_v2`` modeling code of huggingface.co/deepseek-ai/DeepSeek-V2-Lite),
trained with InfoNCE as an embedder (the E5-Mistral recipe,
arXiv:2401.00368: causal attention, last-token pooling).

A layer is ``h = x + MLA(RMSNorm(x))``, then ``h + FFN(RMSNorm(h))``; the
last one is followed by a final RMSNorm.

* MLA: ``q = W_q y`` per head split into ``q_nope`` and ``q_pe``; ``W_kva
  y`` split into the latent ``c_kv`` and one rope key ``k_pe`` that every
  head shares; ``[k_nope | v] = W_kvb RMSNorm(c_kv)``.  Rope rotates pair
  (2i, 2i+1) of ``q_pe`` and ``k_pe`` by ``pos * theta_i`` with YaRN's
  frequencies (``yarn_inv_freq``); the scores ``(q_nope . k_nope + q_pe .
  k_pe) * softmax_scale(cfg)`` are masked causally.
* FFN: a SiLU-gated MLP in the first ``cfg.first_dense`` layers; after
  them a router (f32 softmax over the experts from the f32 normed input,
  the top ``cfg.top_k`` kept with their unnormalised scores) over routed
  SiLU-gated experts, whose weighted outputs add to the shared experts'
  (one SiLU-gated MLP ``n_shared`` experts wide).  No token is dropped.
* Each MoE layer adds the sequence-level balance loss ``alpha * mean over
  rows of sum_e ce_e * mean_pos(score_e)``, ``ce_e`` the row's count of
  expert e over ``L * top_k / n_experts``, every position of the row
  counted.
* Pooling: the final-norm state at each row's last valid position (right
  padding), L2-normalised in f32.

Precision, as ``models.encoder``'s: f32 master weights cast to the compute
dtype at each use, products in it; RMSNorm, the residual stream, the
router, the softmaxes, the combine of the experts' outputs and the pooling
in f32.

The routed experts run without a host read: the assignments are sorted by
expert on the device, each expert's rows taken in one grouped product
(``torch._grouped_mm`` on the card, bf16; an expert at a time on the CPU,
``grouped_product_plain``), and put back with the router's weights.
Spans (while a profiler records): ``tdr_torch.mla.attend``,
``tdr_torch.moe.route``, ``tdr_torch.moe.experts``, ``tdr_torch.moe.shared``;
counters ``moe.tokens`` and ``moe.assignments``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tdr_torch.models.encoder import product
from tdr_torch.ops.precision import ieee_f32
from tdr_torch.utils.config import MlaMoeConfig
from tdr_torch.utils.device import DeviceLike, resolve_device
from tdr_torch.utils.trace import annotate, count


def _dtype(cfg: MlaMoeConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _yarn_mscale(factor: float, mscale: float) -> float:
    return 0.1 * mscale * math.log(factor) + 1.0 if factor > 1 else 1.0


def yarn_inv_freq(cfg: MlaMoeConfig) -> torch.Tensor:
    """YaRN's rotary frequencies for the ``qk_rope_dim`` rope dims, (dim/2,)
    f64: ``theta_i`` blends the base frequency ``theta_extra,i =
    rope_theta^(-2i/dim)`` and its interpolation ``theta_extra,i / factor``
    by the ramp ``m_i = 1 - clamp((i - low) / (high - low), 0, 1)``, where
    ``low`` and ``high`` are the floor and the ceiling of the dims at which
    a wave turns ``beta_fast`` and ``beta_slow`` times over the original
    context."""
    dim, base = cfg.qk_rope_dim, cfg.rope_theta

    def at(turns: float) -> float:
        return dim * math.log(cfg.rope_original_max / (turns * 2 * math.pi)) \
            / (2 * math.log(base))

    low = max(math.floor(at(cfg.beta_fast)), 0)
    high = min(math.ceil(at(cfg.beta_slow)), dim - 1)
    extra = base ** (-torch.arange(0, dim, 2, dtype=torch.float64) / dim)
    ramp = ((torch.arange(dim // 2, dtype=torch.float64) - low)
            / max(high - low, 1e-3)).clamp(0.0, 1.0)
    keep = 1.0 - ramp
    return extra * keep + extra / cfg.rope_factor * (1.0 - keep)


def softmax_scale(cfg: MlaMoeConfig) -> float:
    """``(qk_nope + qk_rope)^-0.5``, times YaRN's ``mscale(factor,
    mscale_all_dim)^2`` where ``mscale_all_dim`` is not 0; 0.1147214 at the
    published config.  (YaRN's rotary tables carry ``mscale(factor,
    mscale) / mscale(factor, mscale_all_dim)``: 1 in the published configs,
    where the two are equal, so the port has no ``mscale`` of its own.)"""
    s = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    if cfg.mscale_all_dim:
        s *= _yarn_mscale(cfg.rope_factor, cfg.mscale_all_dim) ** 2
    return s


def rope_tables(cfg: MlaMoeConfig, L: int, device) -> Tuple[torch.Tensor,
                                                            torch.Tensor]:
    """(cos, sin) of ``pos * theta_i``, (L, dim/2) f32."""
    ang = torch.arange(L, dtype=torch.float64)[:, None] * yarn_inv_freq(cfg)
    return (ang.cos().to(device, torch.float32),
            ang.sin().to(device, torch.float32))


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
           ) -> torch.Tensor:
    """Rope on (B, L, heads, dim): pair (2i, 2i+1) turned by the angle of
    ``cos``/``sin`` (L, dim/2), in f32, rounded back to x's dtype."""
    pairs = x.float().unflatten(-1, (-1, 2))
    a, b = pairs[..., 0], pairs[..., 1]
    c, s = cos[:, None], sin[:, None]
    return torch.stack([a * c - b * s, b * c + a * s], -1).flatten(-2).to(
        x.dtype)


class RMSNorm(nn.Module):
    """``w * x / sqrt(mean(x^2) + eps)`` in f32 (f64 stays f64)."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.eps) \
            * self.weight


def _linear(n_in: int, n_out: int) -> nn.Linear:
    return nn.Linear(n_in, n_out, bias=False)


class LatentAttention(nn.Module):
    """MLA without a query low-rank (DeepSeek-V2-Lite's)."""

    def __init__(self, cfg: MlaMoeConfig):
        super().__init__()
        self.cfg = cfg
        H = cfg.heads
        self.q = _linear(cfg.dim, H * (cfg.qk_nope_dim + cfg.qk_rope_dim))
        self.kv_a = _linear(cfg.dim, cfg.kv_lora_rank + cfg.qk_rope_dim)
        self.kv_norm = RMSNorm(cfg.kv_lora_rank, cfg.rms_eps)
        self.kv_b = _linear(cfg.kv_lora_rank, H * (cfg.qk_nope_dim + cfg.v_dim))
        self.o = _linear(H * cfg.v_dim, cfg.dim)

    def forward(self, y: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
        cfg = self.cfg
        B, L, _ = y.shape
        H, dn, dr, r = (cfg.heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                        cfg.kv_lora_rank)
        q = product(y, self.q.weight, dtype).view(B, L, H, dn + dr)
        kv_a = product(y, self.kv_a.weight, dtype)
        kv = product(self.kv_norm(kv_a[..., :r]), self.kv_b.weight,
                     dtype).view(B, L, H, dn + cfg.v_dim)
        k_pe = rotate(kv_a[..., None, r:], cos, sin).expand(B, L, H, dr)
        q = torch.cat([q[..., :dn], rotate(q[..., dn:], cos, sin)], -1)
        k = torch.cat([kv[..., :dn], k_pe], -1)
        # the softmax in f32 inside the fused attention (its scores
        # accumulate in f32), the probabilities rounded to dtype before v
        o = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2),
            kv[..., dn:].transpose(1, 2), is_causal=True,
            scale=softmax_scale(cfg))
        return product(o.transpose(1, 2).reshape(B, L, -1), self.o.weight,
                       dtype)


def swiglu(y: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    """``W_d (silu(W_g y) * W_u y)`` with ``gate_up = [W_g; W_u]``."""
    h = product(y, gate_up, dtype)
    g, u = h.chunk(2, -1)
    return product(F.silu(g) * u, down, dtype)


class GatedMlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.gate_up = _linear(dim, 2 * hidden)
        self.down = _linear(hidden, dim)

    def forward(self, y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return swiglu(y, self.gate_up.weight, self.down.weight, dtype)


def grouped_product_plain(x: torch.Tensor, w: torch.Tensor,
                          ends: torch.Tensor) -> torch.Tensor:
    """What ``torch._grouped_mm(x, w.mT, offs=ends)`` computes, one expert
    at a time: rows ``ends[e-1]:ends[e]`` of x times ``w[e]^T``; rows past
    the last end are zero.  Reads ``ends`` on the host."""
    parts, start = [], 0
    for e, end in enumerate(ends.tolist()):
        parts.append(F.linear(x[start:end], w[e]))
        start = end
    parts.append(x.new_zeros(x.shape[0] - start, w.shape[1]))
    return torch.cat(parts)


def _grouped(x: torch.Tensor, w: torch.Tensor, ends: torch.Tensor
             ) -> torch.Tensor:
    """One grouped GEMM on the card in bf16; per expert otherwise."""
    if x.is_cuda and w.dtype == torch.bfloat16:
        return torch._grouped_mm(x, w.transpose(-2, -1),
                                 offs=ends.to(torch.int32))
    return grouped_product_plain(x, w, ends)


def grouped_product(x: torch.Tensor, w: torch.Tensor, ends: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    """(M, in) rows grouped by expert, the group of expert e ending at row
    ``ends[e]``, times the (E, out, in) f32 stack cast to ``dtype``: (M,
    out).

    The cast is not kept for the backward: what autograd saves of it is
    cast again from ``w`` when the backward needs it (at the published
    widths 1.1 GB a layer, else held from the forward to the backward)."""
    cast = w.to(dtype)
    if cast is w:                        # no cast: autograd saves w itself
        return _grouped(x, w, ends)
    storage = cast.untyped_storage().data_ptr()

    def pack(t: torch.Tensor):
        if t.untyped_storage().data_ptr() == storage:   # a view of the cast
            return t.storage_offset(), t.size(), t.stride()
        return t

    def unpack(saved):
        if isinstance(saved, tuple):
            offset, size, stride = saved
            return w.detach().to(dtype).as_strided(size, stride, offset)
        return saved

    with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
        return _grouped(x, cast, ends)


class _Dispatch(torch.autograd.Function):
    """(N, D) f32 rows to their (N * k, D) copies in ``dtype`` sorted by
    expert: row j of the output is token ``order[j] // k``.  The backward
    sums each token's k gradients in f32."""

    @staticmethod
    def forward(ctx, y, order, k, dtype):
        ctx.save_for_backward(order)
        ctx.k, ctx.y_dtype = k, y.dtype
        return y.to(dtype)[order // k]

    @staticmethod
    def backward(ctx, g):
        (order,) = ctx.saved_tensors
        out = torch.empty(g.shape, device=g.device, dtype=ctx.y_dtype)
        out[order] = g.to(ctx.y_dtype)
        return out.view(-1, ctx.k, g.shape[1]).sum(1), None, None, None


class _Combine(torch.autograd.Function):
    """The experts' rows (sorted by expert) back in token order, each
    token's k rows weighted by its router scores and summed in f32: (N, D).
    Saves the rows in their own dtype, not an f32 copy."""

    @staticmethod
    def forward(ctx, rows, weights, order):
        ctx.save_for_backward(rows, weights, order)
        N, k = weights.shape
        back = torch.empty_like(rows)
        back[order] = rows
        return torch.bmm(weights[:, None, :],
                         back.view(N, k, -1).to(weights.dtype))[:, 0]

    @staticmethod
    def backward(ctx, g):
        rows, weights, order = ctx.saved_tensors
        N, k = weights.shape
        back = torch.empty_like(rows)
        back[order] = rows
        g_w = torch.bmm(back.view(N, k, -1).to(g.dtype), g[:, :, None])[..., 0]
        g_rows = (weights[..., None] * g[:, None, :]).to(rows.dtype)
        return g_rows.view(N * k, -1)[order], g_w, None


class RoutedExperts(nn.Module):
    """A router over ``n_experts`` SiLU-gated experts of width
    ``expert_hidden``, the top ``top_k`` a token, plus the shared experts."""

    def __init__(self, cfg: MlaMoeConfig):
        super().__init__()
        self.cfg = cfg
        E, D, I = cfg.n_experts, cfg.dim, cfg.expert_hidden
        self.router = _linear(D, E)
        self.gate_up = nn.Parameter(torch.empty(E, 2 * I, D))
        self.down = nn.Parameter(torch.empty(E, D, I))
        self.shared = (GatedMlp(D, cfg.n_shared * I) if cfg.n_shared
                       else None)

    def forward(self, y: torch.Tensor, rows: int, dtype: torch.dtype
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(N, D) f32 normed positions of ``rows`` sequences → (their
        output in f32, this layer's balance loss)."""
        cfg = self.cfg
        N, k, E = y.shape[0], cfg.top_k, cfg.n_experts
        with annotate("tdr_torch.moe.route"):
            scores = torch.softmax(F.linear(y, self.router.weight), -1)
            weights, idx = scores.topk(k, -1)             # (N, k)
            flat = idx.reshape(-1)
            order = torch.argsort(flat, stable=True)
            ends = torch.zeros(E, dtype=torch.int64, device=y.device
                               ).scatter_add_(0, flat, torch.ones_like(flat)
                                              ).cumsum(0)
            x = _Dispatch.apply(y, order, k, dtype)
            count("moe.tokens", N)
        with annotate("tdr_torch.moe.experts"):
            h = grouped_product(x, self.gate_up, ends, dtype)
            g, u = h.chunk(2, -1)
            out = grouped_product(F.silu(g) * u, self.down, ends, dtype)
            routed = _Combine.apply(out, weights, order)
            count("moe.assignments", N * k)
        if self.shared is not None:
            with annotate("tdr_torch.moe.shared"):
                routed = routed + self.shared(y, dtype)
        L = N // rows
        ce = torch.zeros(rows, E, device=y.device).scatter_add_(
            1, idx.view(rows, L * k), torch.ones(rows, L * k, device=y.device)
        ) * (E / (L * k))
        balance = (ce * scores.view(rows, L, E).mean(1)).sum(1).mean()
        return routed, cfg.aux_alpha * balance


class Layer(nn.Module):
    def __init__(self, cfg: MlaMoeConfig, moe: bool):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.dim, cfg.rms_eps)
        self.attn = LatentAttention(cfg)
        self.ffn_norm = RMSNorm(cfg.dim, cfg.rms_eps)
        self.ffn = (RoutedExperts(cfg) if moe
                    else GatedMlp(cfg.dim, cfg.dense_hidden))

    def forward(self, x, cos, sin, dtype) -> Tuple[torch.Tensor,
                                                   Optional[torch.Tensor]]:
        with annotate("tdr_torch.mla.attend"):
            x = x + self.attn(self.attn_norm(x), cos, sin, dtype)
        B, L, D = x.shape
        y = self.ffn_norm(x)
        if isinstance(self.ffn, GatedMlp):
            return x + self.ffn(y, dtype), None
        out, balance = self.ffn(y.view(B * L, D), B, dtype)
        return x + out.view(B, L, D), balance


class MlaMoeEncoder(nn.Module):
    """Token rows → MLA + MoE layers → final RMSNorm → last-token pooling →
    L2-normalised (B, dim) f32 embeddings."""

    def __init__(self, cfg: MlaMoeConfig):
        super().__init__()
        self.cfg = cfg
        self.tok_embed = nn.Embedding(cfg.vocab_size, cfg.dim)
        self.layers = nn.ModuleList(
            Layer(cfg, moe=i >= cfg.first_dense) for i in range(cfg.depth))
        self.norm = RMSNorm(cfg.dim, cfg.rms_eps)
        # (L, device) -> rope_tables: made once, so that a forward copies
        # nothing from the host (a pageable copy waits for the device)
        self._rope: Dict[Tuple[int, str], Tuple[torch.Tensor, torch.Tensor]] = {}

    @ieee_f32()
    def forward_with_aux(self, ids: torch.Tensor, mask: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, L) ids and right-padded mask → ((B, dim) unit embeddings,
        the balance loss summed over the MoE layers)."""
        dtype = _dtype(self.cfg)
        B, L = ids.shape
        key = (L, str(ids.device))
        if key not in self._rope:
            # outside inference mode, so that a train step after encode()
            # may save them for its backward
            with torch.inference_mode(False):
                self._rope[key] = rope_tables(self.cfg, L, ids.device)
        cos, sin = self._rope[key]
        x = F.embedding(ids.long(), self.tok_embed.weight)
        balances: List[torch.Tensor] = []
        for layer in self.layers:
            x, balance = layer(x, cos, sin, dtype)
            if balance is not None:
                balances.append(balance)
        last = ((mask > 0).sum(1) - 1).clamp_min(0)
        h = self.norm(x[torch.arange(B, device=x.device), last])
        emb = h / h.norm(dim=-1, keepdim=True).clamp_min(1e-6)
        aux = (torch.stack(balances).sum() if balances
               else emb.new_zeros(()))
        return emb, aux

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return self.forward_with_aux(ids, mask)[0]


def init_mla_moe(cfg: MlaMoeConfig, seed: int = 0,
                 device: DeviceLike = None) -> MlaMoeEncoder:
    """An ``MlaMoeEncoder`` drawn on ``device`` from a ``torch.Generator``
    there seeded with ``seed`` (no host copy of the weights): normal(0,
    0.02) for every matrix and embedding row, unit RMSNorm scales.  One
    seed gives the same weights on one kind of device."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = MlaMoeEncoder(cfg)
    model = model.to_empty(device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=gen)
    return model.eval()
