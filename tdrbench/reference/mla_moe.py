"""The reference's DeepSeek-V2 MLA + MoE encoder training step, in plain
float32 torch with TF32 off: the configuration's block (the published
``deepseek_v2`` keys of its file), causal, last-token pooled and
L2-normalised, trained with InfoNCE over in-batch negatives plus the
sequence-level balance loss, and AdamW.

Forward, per layer: ``h = x + MLA(RMSNorm(x))``, ``x = h + FFN(RMSNorm(h))``
with ``RMSNorm(x) = w x / sqrt(mean(x^2) + rms_norm_eps)``.

* MLA (no query low-rank): ``q = W_q y`` per head, its last
  ``qk_rope_head_dim`` dims rotated; ``W_kva y`` split into the latent
  (``kv_lora_rank``) and one rotated key shared by the heads; ``[k_nope |
  v] = W_kvb RMSNorm(latent)``.  Rope turns pair (2i, 2i+1) by ``pos *
  theta_i``, YaRN: ``theta_i = extra_i m_i + extra_i / factor (1 - m_i)``,
  ``extra_i = rope_theta^(-2i/dim)``, ``m_i = 1 - clamp((i - low) / (high -
  low), 0, 1)``, ``low = floor(c(beta_fast))``, ``high =
  ceil(c(beta_slow))``, ``c(b) = dim ln(original / (2 pi b)) / (2 ln
  rope_theta)``.  Scores ``q . k`` times ``192^-0.5 (0.1 mscale_all_dim ln
  factor + 1)^2``, causal, softmax, then ``v`` and ``W_o``.
* FFN: ``W_d (silu(W_g y) * W_u y)`` in the first ``first_k_dense_replace``
  layers; after them ``softmax(W_r y)`` over ``n_routed_experts``, the top
  ``num_experts_per_tok`` kept unnormalised, ``sum_top w_e E_e(y) + S(y)``
  with each expert a SiLU-gated MLP of ``moe_intermediate_size`` and ``S``
  the ``n_shared_experts`` as one of that many times the width.  Every
  token reaches its experts (a Python loop over them).
* Balance loss a row: ``alpha sum_e ce_e mean_pos(score_e)``, ``ce_e`` the
  row's count of e over ``L k / n_routed_experts``, every position of the
  row counted, summed over the MoE layers; the loss adds its mean over the
  rows to InfoNCE.
* The final RMSNorm at each row's last valid position, then division by
  the L2 norm (at least 1e-6).

``rounding`` is applied to both operands of every product that the
configuration computes in its compute type (the router's is float32); the
identity gives the reference, a coarser rounding the control.  The
gradient is taken in row chunks, as ``encoder.py`` does.  The parameters
are named as the program's state dict names them.  Nothing here imports
the program."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from tdrbench.reference.encoder import (Params, Rounding, identity,
                                        ieee_f32, infonce)


def yarn_freqs(cfg: dict) -> torch.Tensor:
    rs = cfg["rope_scaling"]
    dim, base = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])

    def c(b):
        return dim * math.log(rs["original_max_position_embeddings"]
                              / (2 * math.pi * b)) / (2 * math.log(base))

    low = max(math.floor(c(rs["beta_fast"])), 0)
    high = min(math.ceil(c(rs["beta_slow"])), dim - 1)
    i = torch.arange(dim // 2, dtype=torch.float64)
    extra = base ** (-2 * i / dim)
    m = 1 - ((i - low) / max(high - low, 1e-3)).clamp(0, 1)
    return extra * m + extra / rs["factor"] * (1 - m)


def _mscale(factor: float, m: float) -> float:
    return 0.1 * m * math.log(factor) + 1 if factor > 1 else 1.0


def scale(cfg: dict) -> float:
    rs = cfg["rope_scaling"]
    s = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    if rs.get("mscale_all_dim"):
        s *= _mscale(rs["factor"], rs["mscale_all_dim"]) ** 2
    return s


def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _rope(x, cos, sin):
    a, b = x[..., 0::2], x[..., 1::2]
    out = torch.empty_like(x)
    out[..., 0::2] = a * cos - b * sin
    out[..., 1::2] = b * cos + a * sin
    return out


def encode(p: Params, ids: torch.Tensor, mask: torch.Tensor, cfg: dict,
           rnd: Rounding = identity) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, L) ids and right-padded mask → ((B, hidden) unit embeddings,
    (B,) each row's balance loss summed over the MoE layers)."""
    def lin(x, w):
        return rnd(x) @ rnd(w).T

    def swiglu(y, gu, d):
        g, u = lin(y, gu).chunk(2, -1)
        return lin(F.silu(g) * u, d)

    B, L = ids.shape
    H, dn, dr = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                 cfg["qk_rope_head_dim"])
    r, dv, eps = cfg["kv_lora_rank"], cfg["v_head_dim"], cfg["rms_norm_eps"]
    E, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    rs = cfg["rope_scaling"]
    ang = torch.arange(L, dtype=torch.float64)[:, None] * yarn_freqs(cfg)
    m = _mscale(rs["factor"], rs["mscale"]) / _mscale(rs["factor"],
                                                      rs["mscale_all_dim"])
    cos = (ang.cos() * m).float().to(ids.device)[:, None]
    sin = (ang.sin() * m).float().to(ids.device)[:, None]
    causal = torch.ones(L, L, dtype=torch.bool, device=ids.device).tril()
    x = p["tok_embed.weight"][ids]
    balance = torch.zeros(B, device=ids.device)
    for i in range(cfg["num_hidden_layers"]):
        pre = f"layers.{i}."
        a = pre + "attn."
        y = _rms(x, p[pre + "attn_norm.weight"], eps)
        q = lin(y, p[a + "q.weight"]).view(B, L, H, dn + dr)
        kva = lin(y, p[a + "kv_a.weight"])
        kv = lin(_rms(kva[..., :r], p[a + "kv_norm.weight"], eps),
                 p[a + "kv_b.weight"]).view(B, L, H, dn + dv)
        q = torch.cat([q[..., :dn], _rope(q[..., dn:], cos, sin)], -1)
        k_pe = _rope(kva[..., None, r:], cos, sin).expand(B, L, H, dr)
        key = torch.cat([kv[..., :dn], k_pe], -1)
        s = (rnd(q.transpose(1, 2)) @ rnd(key.permute(0, 2, 3, 1))) * scale(cfg)
        s = s.masked_fill(~causal, float("-inf"))
        o = rnd(torch.softmax(s, -1)) @ rnd(kv[..., dn:].transpose(1, 2))
        x = x + lin(o.transpose(1, 2).reshape(B, L, H * dv), p[a + "o.weight"])
        y = _rms(x, p[pre + "ffn_norm.weight"], eps)
        f = pre + "ffn."
        if i < cfg["first_k_dense_replace"]:
            x = x + swiglu(y, p[f + "gate_up.weight"], p[f + "down.weight"])
            continue
        flat = y.reshape(B * L, -1)
        scores = torch.softmax(flat @ p[f + "router.weight"].T, -1)
        w, idx = scores.topk(k, -1)
        out = torch.zeros_like(flat)
        gate_up, down = p[f + "gate_up"].unbind(0), p[f + "down"].unbind(0)
        for e in range(E):
            tok, slot = (idx == e).nonzero(as_tuple=True)
            if len(tok):
                h = swiglu(flat[tok], gate_up[e], down[e])
                out = out.index_add(0, tok, h * w[tok, slot, None])
        if cfg["n_shared_experts"]:
            out = out + swiglu(flat, p[f + "shared.gate_up.weight"],
                               p[f + "shared.down.weight"])
        x = x + out.view(B, L, -1)
        ce = torch.zeros(B, E, device=ids.device).index_put_(
            (torch.arange(B, device=ids.device)[:, None].expand(B, L * k),
             idx.view(B, L * k)), torch.ones(B, L * k, device=ids.device),
            accumulate=True) / (L * k / E)
        balance = balance + cfg["aux_loss_alpha"] * (
            ce * scores.view(B, L, E).mean(1)).sum(1)
    last = ((mask > 0).sum(1) - 1).clamp_min(0)
    h = _rms(x[torch.arange(B, device=ids.device), last], p["norm.weight"], eps)
    return h / h.norm(dim=-1, keepdim=True).clamp_min(1e-6), balance


def loss_and_grad(p: Params, batch: Tuple[torch.Tensor, ...], cfg: dict,
                  temperature: float, rnd: Rounding = identity,
                  chunk: int = 16) -> Tuple[float, Params]:
    """The loss (InfoNCE plus the mean balance loss) of one (q_ids,
    q_mask, p_ids, p_mask) batch and its gradient for every parameter."""
    q_ids, q_mask, p_ids, p_mask = batch
    ids, mask = torch.cat([q_ids, p_ids]), torch.cat([q_mask, p_mask])
    n = len(ids)
    with torch.no_grad():
        parts = [encode(p, ids[s:s + chunk], mask[s:s + chunk], cfg, rnd)
                 for s in range(0, n, chunk)]
    emb = torch.cat([e for e, _ in parts]).requires_grad_(True)
    aux = torch.cat([b for _, b in parts]).mean()
    B = q_ids.shape[0]
    nce = infonce(emb[:B], emb[B:], temperature)
    nce.backward()
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    for s in range(0, n, chunk):
        out, bal = encode(leaves, ids[s:s + chunk], mask[s:s + chunk], cfg, rnd)
        ((out * emb.grad[s:s + chunk]).sum() + bal.sum() / n).backward()
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
             for k, v in leaves.items()}
    return float(nce.detach() + aux), grads


class AdamW:
    """``p *= 1 - lr wd``, then ``p -= lr m_hat / (sqrt(v_hat) + eps)``, in
    place (the moments too)."""

    def __init__(self, p: Params, lr: float, weight_decay: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, self.wd, self.betas, self.eps = lr, weight_decay, betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in p.items()}
        self.v = {k: torch.zeros_like(v) for k, v in p.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, p: Params, g: Params) -> None:
        self.t += 1
        b1, b2 = self.betas
        for k in p:
            m, v = self.m[k], self.v[k]
            m.mul_(b1).add_(g[k], alpha=1 - b1)
            v.mul_(b2).addcmul_(g[k], g[k], value=1 - b2)
            denom = (v / (1 - b2 ** self.t)).sqrt_().add_(self.eps)
            p[k].mul_(1 - self.lr * self.wd).addcdiv_(
                m, denom, value=-self.lr / (1 - b1 ** self.t))


def follow(p: Params, batches: List[Tuple[torch.Tensor, ...]], cfg: dict,
           train: dict, rnd: Rounding = identity, chunk: int = 16):
    """The reference's first steps from ``p``, which it updates in place:
    (loss of each step, the L2 norm of the first step's gradient by leaf,
    ``p`` after the last step)."""
    opt = AdamW(p, train["lr"], train["weight_decay"])
    losses: List[float] = []
    g1: Dict[str, float] = {}
    with ieee_f32():
        for batch in batches:
            loss, g = loss_and_grad(p, batch, cfg, train["temperature"], rnd,
                                    chunk)
            losses.append(loss)
            if not g1:
                g1 = {k: float(v.double().norm()) for k, v in g.items()}
            opt.step(p, g)
            del g
    return losses, g1, p
