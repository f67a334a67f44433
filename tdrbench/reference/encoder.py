"""The reference's dense-encoder training step, in plain float32 torch with
TF32 off: the configuration's pre-LN transformer encoder, mean-pooled and
L2-normalised, trained with InfoNCE over in-batch negatives and AdamW.

Forward, per the configuration file: token rows plus learned positions;
per block ``x += W_o attn(LN1(x)) + b_o`` then ``x += W_d gelu(W_u LN2(x)
+ b_u) + b_d``, with LayerNorm eps ``layer_norm_eps`` and the variance
E[x^2] - E[x]^2, the query divided by sqrt(head size), masked keys at the
float32 minimum (a padded query row then attends uniformly), tanh GELU;
a final LayerNorm, the mean over the valid tokens, then division by the
L2 norm (at least 1e-6).  Loss: cross entropy of q . p / temperature over
the batch's positives.  AdamW: decoupled decay ``p *= 1 - lr wd``, then
``p -= lr m_hat / (sqrt(v_hat) + eps)``.

``rounding`` is applied to both operands of every product that the
configuration computes in its compute type; the identity gives the
reference, a coarser rounding the control.  The gradient is taken in row
chunks (embeddings first without a graph, then each chunk's forward again
with the loss's gradient of its rows), which is the same gradient in less
memory.  Nothing here imports the program."""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
Rounding = Callable[[torch.Tensor], torch.Tensor]


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _fp8(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    scale = top / x.detach().abs().amax().clamp_min(1e-30)
    return ((x * scale).clamp(-top, top).to(dtype).to(torch.float32)
            / scale)


class _Fp8(torch.autograd.Function):
    """Per-tensor scaled float8 rounding: e4m3 (largest 448) on the way
    forward, e5m2 (largest 57344) for the gradient on the way back, the
    usual float8 training recipe."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, 57344.0)


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(x)


@contextlib.contextmanager
def ieee_f32():
    """Full float32 products (no TF32) inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


def _ln(x, w, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x * x).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def encode(p: Params, ids: torch.Tensor, mask: torch.Tensor, cfg: dict,
           rnd: Rounding = identity) -> torch.Tensor:
    """(B, L) ids and mask → (B, hidden) unit embeddings."""
    def lin(x, name):
        return rnd(x) @ rnd(p[name + ".weight"]).T + p[name + ".bias"]

    B, L = ids.shape
    H = cfg["num_attention_heads"]
    eps = cfg["layer_norm_eps"]
    x = p["tok_embed.weight"][ids] + p["pos_embed"][:L]
    valid = mask > 0
    keep = valid[:, None, :, None] & valid[:, None, None, :]
    for b in range(cfg["num_hidden_layers"]):
        pre = f"blocks.{b}."
        y = _ln(x, p[pre + "ln1.weight"], p[pre + "ln1.bias"], eps)
        q, k, v = (lin(y, pre + "attn." + n).view(B, L, H, -1).transpose(1, 2)
                   for n in ("query", "key", "value"))
        q = q / math.sqrt(q.shape[-1])
        s = (rnd(q) @ rnd(k).transpose(-1, -2)).masked_fill(
            ~keep, torch.finfo(torch.float32).min)
        o = rnd(torch.softmax(s, -1)) @ rnd(v)
        x = x + lin(o.transpose(1, 2).reshape(B, L, -1), pre + "attn.out")
        y = _ln(x, p[pre + "ln2.weight"], p[pre + "ln2.bias"], eps)
        h = F.gelu(lin(y, pre + "mlp.up"), approximate="tanh")
        x = x + lin(h, pre + "mlp.down")
    x = _ln(x, p["ln_out.weight"], p["ln_out.bias"], eps)
    m = mask[..., None].float()
    pooled = (x * m).sum(1) / m.sum(1).clamp_min(1.0)
    return pooled / pooled.norm(dim=-1, keepdim=True).clamp_min(1e-6)


def infonce(q: torch.Tensor, pos: torch.Tensor, temperature: float):
    logits = q @ pos.T / temperature
    return F.cross_entropy(logits, torch.arange(q.shape[0], device=q.device))


def loss_and_grad(p: Params, batch: Tuple[torch.Tensor, ...], cfg: dict,
                  temperature: float, rnd: Rounding = identity,
                  chunk: int = 512) -> Tuple[float, Params]:
    """The loss of one (q_ids, q_mask, p_ids, p_mask) batch and its gradient
    for every parameter."""
    q_ids, q_mask, p_ids, p_mask = batch
    ids, mask = torch.cat([q_ids, p_ids]), torch.cat([q_mask, p_mask])
    with torch.no_grad():
        emb = torch.cat([encode(p, ids[s:s + chunk], mask[s:s + chunk], cfg, rnd)
                         for s in range(0, len(ids), chunk)])
    emb.requires_grad_(True)
    B = q_ids.shape[0]
    loss = infonce(emb[:B], emb[B:], temperature)
    loss.backward()
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    for s in range(0, len(ids), chunk):
        out = encode(leaves, ids[s:s + chunk], mask[s:s + chunk], cfg, rnd)
        out.backward(emb.grad[s:s + chunk])
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
             for k, v in leaves.items()}
    return float(loss.detach()), grads


class AdamW:
    def __init__(self, p: Params, lr: float, weight_decay: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, self.wd, self.betas, self.eps = lr, weight_decay, betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in p.items()}
        self.v = {k: torch.zeros_like(v) for k, v in p.items()}
        self.t = 0

    def step(self, p: Params, g: Params) -> Params:
        self.t += 1
        b1, b2 = self.betas
        out = {}
        for k in p:
            self.m[k] = b1 * self.m[k] + (1 - b1) * g[k]
            self.v[k] = b2 * self.v[k] + (1 - b2) * g[k] * g[k]
            m_hat = self.m[k] / (1 - b1 ** self.t)
            v_hat = self.v[k] / (1 - b2 ** self.t)
            out[k] = (p[k] * (1 - self.lr * self.wd)
                      - self.lr * m_hat / (v_hat.sqrt() + self.eps))
        return out


def follow(p0: Params, batches: List[Tuple[torch.Tensor, ...]], cfg: dict,
           train: dict, rnd: Rounding = identity):
    """The reference's first steps from ``p0``: (loss of each step, the first
    step's gradient, the parameters after the last step)."""
    p = {k: v.detach().float().clone() for k, v in p0.items()}
    opt = AdamW(p, train["lr"], train["weight_decay"])
    losses, first = [], None
    with ieee_f32():
        for batch in batches:
            loss, g = loss_and_grad(p, batch, cfg, train["temperature"], rnd)
            losses.append(loss)
            first = g if first is None else first
            with torch.no_grad():
                p = opt.step(p, g)
    return losses, first, p
