"""Top-k over a long document axis, in ``lax.top_k``'s order.

Counterpart of ``tdr/ops/topk.py``.  ``lax.top_k`` orders by value
descending and, among equal values, by index ascending.  Bare
``torch.topk`` does not promise that order for ties (on one tied row it
returned ``[1, 4, 7, 8, 2]`` where ``lax.top_k`` gives ``[1, 2, 4, 7, 8]``),
so every selection here goes through a stable sort instead.
"""

from __future__ import annotations

from typing import Tuple

import torch


def sort_desc_by_value_then_index(vals: torch.Tensor, idx: torch.Tensor
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort each row by (value descending, idx ascending): a stable sort on
    idx, then a stable descending sort on value."""
    o = torch.argsort(idx, dim=-1, stable=True)
    vals, idx = vals.gather(-1, o), idx.gather(-1, o)
    o = torch.argsort(vals, dim=-1, descending=True, stable=True)
    return vals.gather(-1, o), idx.gather(-1, o)


def fast_topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis with ``lax.top_k``'s tie order: a stable
    descending sort keeps equal values in index order.  Indices are int64."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_grouped(scores: torch.Tensor, k: int, group: int = 128
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact grouped top-k of a 2-D score matrix, identical to
    ``fast_topk(scores, k)`` (the proof is in ``tdr.ops.topk.topk_grouped``):
    group maxima, top-k groups, then a (value desc, index asc) selection
    among the winning groups' columns."""
    Q, N = scores.shape
    ng = N // group
    if N % group or ng < k or k * group * 2 >= N:
        return fast_topk(scores, k)
    gmax = scores.view(Q, ng, group).amax(dim=-1)
    _, gsel = fast_topk(gmax, k)
    offs = torch.arange(group, device=scores.device)
    cols = (gsel[..., None] * group + offs).reshape(Q, k * group)
    cand = scores.gather(1, cols)
    vals, idx = sort_desc_by_value_then_index(cand, cols)
    return vals[:, :k], idx[:, :k]


def merge_gathered_topk(vals_g: torch.Tensor, rows_g: torch.Tensor,
                        top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(S, Q, k_local) per-shard candidates → global (Q, top_k), padded with
    (-inf, 0) when fewer than ``top_k`` candidates exist."""
    S, Q, kl = vals_g.shape
    vals_m = vals_g.permute(1, 0, 2).reshape(Q, S * kl)
    rows_m = rows_g.permute(1, 0, 2).reshape(Q, S * kl)
    k_eff = min(top_k, S * kl)
    vals, sel = fast_topk(vals_m, k_eff)
    rows = rows_m.gather(1, sel)
    if k_eff < top_k:
        pad = top_k - k_eff
        vals = torch.nn.functional.pad(vals, (0, pad), value=float("-inf"))
        rows = torch.nn.functional.pad(rows, (0, pad))
    return vals, rows
