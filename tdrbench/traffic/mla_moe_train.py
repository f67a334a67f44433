"""Kind ``mla_moe_train``: the MLA + MoE encoder (DeepSeek-V2's block,
``tdr_torch.models.mla_moe``) trained as an embedder, as ``contrastive_train``
trains the dense encoder.

Each step takes ``pairs_per_step`` (query, positive) pairs hashed to
``seq_len`` tokens and runs ``make_train_step()``'s step on a
``create_train_state`` state for the configuration, loaded with the
harness's seeded weights: InfoNCE over in-batch negatives plus the MoE's
balance loss, then AdamW.  The pairs, their order, the first steps and the
window are ``contrastive_train``'s.

The weights (``make_weights``) are drawn on the device a leaf at a time,
each from its own generator seeded by the run's seed and the leaf's place,
so that any leaf can be drawn again alone: set-up keeps no copy of the
initial weights, and the check draws them again for the reference
(``reference/mla_moe.py``, in row chunks of ``reference_chunk``
sequences) once the program's state is released.  ``correct`` holds the
first steps' losses, the first gradient's norms and the change's norms by
leaf to the reference's, as ``contrastive_train`` does.

Faults planted in the timed path (``FAULTS``): ``contrastive_train``'s,
and the program configured with one expert a token fewer (``top5``),
without its shared experts (``no_shared``) or without YaRN's mscale
(``no_mscale``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from tdrbench.traffic import contrastive_train as base

# the published keys the program implements at these values only
FIXED = {"attention_bias": False, "hidden_act": "silu", "moe_layer_freq": 1,
         "n_group": 1, "norm_topk_prob": False, "q_lora_rank": None,
         "routed_scaling_factor": 1, "scoring_func": "softmax",
         "seq_aux": True, "topk_group": 1, "topk_method": "greedy",
         "tie_word_embeddings": False}


def weight_shapes(m: dict) -> Dict[str, Tuple[int, ...]]:
    """The encoder's parameters by the program's state-dict names, in
    order."""
    D, H, V = m["hidden_size"], m["num_attention_heads"], m["vocab_size"]
    dn, dr, dv = m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"]
    r, E, I = m["kv_lora_rank"], m["n_routed_experts"], m["moe_intermediate_size"]
    out = {"tok_embed.weight": (V, D)}
    for i in range(m["num_hidden_layers"]):
        pre = f"layers.{i}."
        out.update({pre + "attn_norm.weight": (D,),
                    pre + "attn.q.weight": (H * (dn + dr), D),
                    pre + "attn.kv_a.weight": (r + dr, D),
                    pre + "attn.kv_norm.weight": (r,),
                    pre + "attn.kv_b.weight": (H * (dn + dv), r),
                    pre + "attn.o.weight": (D, H * dv),
                    pre + "ffn_norm.weight": (D,)})
        f = pre + "ffn."
        if i < m["first_k_dense_replace"]:
            F = m["intermediate_size"]
            out.update({f + "gate_up.weight": (2 * F, D),
                        f + "down.weight": (D, F)})
            continue
        S = m["n_shared_experts"] * I
        out.update({f + "router.weight": (E, D),
                    f + "gate_up": (E, 2 * I, D), f + "down": (E, D, I),
                    f + "shared.gate_up.weight": (2 * S, D),
                    f + "shared.down.weight": (D, S)})
    out["norm.weight"] = (D,)
    return out


def make_weights(m: dict, seed: int, device, std: float
                 ) -> Iterator[Tuple[str, "object"]]:
    """(name, float32 tensor on ``device``) for every parameter in
    ``weight_shapes``' order: unit RMSNorm scales, normal(0, ``std``) for
    the rest, leaf i from a generator seeded by (seed, 4, i)."""
    import torch

    for i, (name, shape) in enumerate(weight_shapes(m).items()):
        if name.endswith("norm.weight"):
            yield name, torch.ones(shape, device=device)
            continue
        s = int(np.random.SeedSequence([seed, 4, i]).generate_state(
            1, np.uint64)[0] >> 1)
        gen = torch.Generator(device=device).manual_seed(s)
        yield name, torch.randn(shape, generator=gen, device=device) * std


def program_config(m: dict, seq_len: int, dtype: str,
                   fault: Optional[str] = None):
    """The program's ``MlaMoeConfig`` for the configuration file ``m``; a
    fault changes it as ``Run.FAULTS`` says."""
    from tdr_torch.utils.config import MlaMoeConfig

    rs = m["rope_scaling"]
    wrong = {k: m.get(k) for k, v in FIXED.items() if m.get(k) != v}
    if wrong or rs["mscale"] != rs["mscale_all_dim"]:
        raise ValueError(f"the program implements {FIXED} and YaRN's mscale "
                         f"equal to mscale_all_dim; the file has {wrong}, "
                         f"{rs}")
    cfg = MlaMoeConfig(
        vocab_size=m["vocab_size"], dim=m["hidden_size"],
        depth=m["num_hidden_layers"], heads=m["num_attention_heads"],
        kv_lora_rank=m["kv_lora_rank"], qk_nope_dim=m["qk_nope_head_dim"],
        qk_rope_dim=m["qk_rope_head_dim"], v_dim=m["v_head_dim"],
        dense_hidden=m["intermediate_size"],
        first_dense=m["first_k_dense_replace"],
        n_experts=m["n_routed_experts"], top_k=m["num_experts_per_tok"],
        expert_hidden=m["moe_intermediate_size"],
        n_shared=m["n_shared_experts"], rope_theta=float(m["rope_theta"]),
        rope_factor=float(rs["factor"]),
        rope_original_max=rs["original_max_position_embeddings"],
        beta_fast=float(rs["beta_fast"]), beta_slow=float(rs["beta_slow"]),
        mscale_all_dim=rs["mscale_all_dim"],
        rms_eps=m["rms_norm_eps"], aux_alpha=m["aux_loss_alpha"],
        max_len=seq_len, dtype=dtype)
    change = {"top5": dict(top_k=cfg.top_k - 1), "no_shared": dict(n_shared=0),
              "no_mscale": dict(mscale_all_dim=0.0)}
    return dataclasses.replace(cfg, **change.get(fault, {}))


class Run(base.Run):
    FAULTS = base.Run.FAULTS + ("top5", "no_shared", "no_mscale")

    def __init__(self, config: dict, mix: dict, seed: int, device: str = "cuda",
                 fault: Optional[str] = None):
        super().__init__(config, mix, seed, device, fault)
        self.L = mix["seq_len"]

    def weights(self):
        return make_weights(self.model_cfg, self.seed, self.device,
                            self.train["init_std"])

    def setup(self) -> None:
        """As ``contrastive_train``'s, with the weights copied into the
        program's state a leaf at a time and the change measured against
        leaves drawn again.  Inputs already made (a calibration's second
        run of one seed) are kept."""
        import torch

        from tdr_torch.train import create_train_state, make_train_step

        m, t = self.model_cfg, self.train
        marks = [time.perf_counter()]
        if not hasattr(self, "order"):
            self.make_inputs()
        marks.append(time.perf_counter())
        self.state = create_train_state(
            program_config(m, self.L, t["compute_dtype"], self.fault),
            lr=t["lr"], weight_decay=t["weight_decay"], seed=0,
            device=self.device)
        named = dict(self.state.model.named_parameters())
        with torch.no_grad():
            for name, w in self.weights():
                if name in named:            # a fault may lack a leaf
                    named[name].copy_(w)
        self.step_fn = make_train_step(temperature=t["temperature"])
        marks.append(time.perf_counter())
        self.first_losses = []
        for i in range(self.mix["first_steps"]):
            self.first_losses.append(float(self.one_step(i)))
            if i == 0:
                beta1 = self.state.optimizer.param_groups[0]["betas"][0]
                held = self.state.optimizer.state
                self.grad1 = {
                    k: (float((held[p]["exp_avg"] / (1 - beta1)).double()
                              .norm()) if p in held else 0.0)
                    for k, p in named.items()}
        self.change = {k: 0.0 for k in weight_shapes(m)}
        self.grad1 = {k: self.grad1.get(k, 0.0) for k in self.change}
        with torch.no_grad():
            for name, w in self.weights():
                if name in named:
                    self.change[name] = float(
                        (named[name] - w).double().norm())
        self.next_step = self.mix["first_steps"]
        if self.device != "cpu":
            torch.cuda.synchronize()
        marks.append(time.perf_counter())
        self.setup_parts = dict(zip(("inputs", "weights and state",
                                     "first steps"), np.diff(marks)))

    def readings(self, rnd=None) -> Dict[str, object]:
        """The reference's readings of the first steps from the same
        weights, drawn again, and texts; ``rnd`` rounds its products (the
        control)."""
        from tdrbench.reference import mla_moe as ref

        n = self.mix["first_steps"]
        losses, g1, p_n = ref.follow(dict(self.weights()),
                                     self.reference_batches(n),
                                     self.model_cfg, self.train,
                                     rnd or ref.identity,
                                     self.mix["reference_chunk"])
        change = {k: float((p_n.pop(k) - w).double().norm())
                  for k, w in self.weights()}
        return {"losses": losses, "grad1": g1, "change": change}

    def layer_inputs(self) -> Dict:
        """What the traced run's readers take: the steps completed in the
        traced part of the window, their model FLOPs and their routed
        experts' forward FLOPs (``arith_mla_moe``), the peak, and the
        experts a token."""
        from tdrbench.harness import arith, arith_mla_moe

        m, n = self.model_cfg, 2 * self.B
        return {"steps": len(self.losses) - self.traced_from,
                "step_flops": arith_mla_moe.step_flops(m, n, self.L),
                "experts_fwd_flops": arith_mla_moe.experts_fwd_flops(
                    m, n, self.L),
                "peak_flops": arith.PEAK_BF16_FLOPS,
                "top_k": m["num_experts_per_tok"]}
