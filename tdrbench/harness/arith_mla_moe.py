"""The yardstick's arithmetic for the MLA + MoE encoder (DeepSeek-V2's
block): its model FLOPs a train step and its routed experts' forward
FLOPs, from the configuration file's published keys.  Frozen, so that the
numbers do not move when the program changes."""

from __future__ import annotations


def _moe_layers(m: dict) -> int:
    return m["num_hidden_layers"] - m["first_k_dense_replace"]


def active_macs(m: dict, seq_len: int) -> float:
    """Multiply-adds a position in one forward: each layer's MLA
    projections (q, kv_a, kv_b, o) and its two L^2 products (q . k over
    the rope and nope dims, P . v), halved for the causal mask; the dense
    layers' gated MLP; each MoE layer's router, its top-k experts and its
    shared experts (gate, up and down each)."""
    D, H = m["hidden_size"], m["num_attention_heads"]
    dn, dr, dv = m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"]
    r = m["kv_lora_rank"]
    proj = D * H * (dn + dr) + D * (r + dr) + r * H * (dn + dv) + H * dv * D
    scores = H * (dn + dr + dv) * seq_len / 2.0
    dense = 3 * D * m["intermediate_size"]
    I = m["moe_intermediate_size"]
    moe = (D * m["n_routed_experts"]
           + 3 * D * I * (m["num_experts_per_tok"] + m["n_shared_experts"]))
    return (m["num_hidden_layers"] * (proj + scores)
            + m["first_k_dense_replace"] * dense + _moe_layers(m) * moe)


def step_flops(m: dict, n_seq: int, seq_len: int) -> float:
    """Model FLOPs of one train step: 6 (2 a multiply-add, forward and
    backward) x ``active_macs`` x positions."""
    return 6.0 * active_macs(m, seq_len) * n_seq * seq_len


def experts_fwd_flops(m: dict, n_seq: int, seq_len: int) -> float:
    """FLOPs of the routed experts' products in one forward: positions x
    top-k x 3 products x 2 x hidden x expert width x MoE layers."""
    return (n_seq * seq_len * m["num_experts_per_tok"] * 3 * 2
            * m["hidden_size"] * m["moe_intermediate_size"] * _moe_layers(m))
