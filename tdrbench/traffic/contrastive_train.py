"""Kind ``contrastive_train``: dense-encoder training as a trainer runs it.

Each step takes ``pairs_per_step`` (query, positive document) pairs, hashes
them with the program's ``encode_batch`` (as ``make_batches`` does) and
runs ``make_train_step()``'s step on a ``create_train_state`` state loaded
with the harness's seeded weights: InfoNCE over in-batch negatives, then
AdamW.  Pairs come from a synthetic corpus made from the seed (the frozen
generator): ``pool_docs`` documents and ``pool_pairs`` queries, each
paired with the document it was drawn from; steps take the pairs in a
seeded order, all different until the pool is used up.  A mix file gives
those three numbers.

Set-up runs the first ``first_steps`` steps through the window's own feed
and call (they also warm it up) and keeps what the comparison needs: each
step's loss, the first gradient as the optimizer holds it after step 1
(``exp_avg / (1 - beta1)``), and the change of every parameter after the
last of them.  ``correct`` holds those to the reference's own first steps
(``reference/encoder.py``) from the same weights and texts.
"""

from __future__ import annotations

import gc
import statistics
import time
from typing import Dict, List, Optional

import numpy as np

from tdrbench.harness.synthetic import SyntheticSpec, synthetic_corpus
from tdrbench.harness.trace import Tracing, span


def make_weights(model: dict, seed: int, device) -> Dict:
    """The encoder's float32 parameters from the seed, by the names of the
    program's state dict: normal(0, 0.02) token rows and positions,
    xavier-uniform kernels (one uniform draw shared out over all of them),
    zero biases and LayerNorm shifts, unit LayerNorm scales."""
    import torch

    d, L = model["hidden_size"], model["max_position_embeddings"]
    V, hid = model["vocab_size"], model["intermediate_size"]
    gen = torch.Generator(device=device).manual_seed(seed)
    emb = torch.randn((V + L) * d, generator=gen, device=device) * 0.02
    shapes = {}
    for b in range(model["num_hidden_layers"]):
        pre = f"blocks.{b}."
        for n in ("query", "key", "value", "out"):
            shapes[pre + f"attn.{n}"] = (d, d)
        shapes[pre + "mlp.up"] = (hid, d)
        shapes[pre + "mlp.down"] = (d, hid)
    flat = torch.rand(sum(a * b for a, b in shapes.values()), generator=gen,
                      device=device) * 2 - 1
    p = {"tok_embed.weight": emb[: V * d].view(V, d),
         "pos_embed": emb[V * d:].view(L, d)}
    at = 0
    for b in range(model["num_hidden_layers"]):
        pre = f"blocks.{b}."
        for ln in ("ln1", "ln2"):
            p[pre + ln + ".weight"] = torch.ones(d, device=device)
            p[pre + ln + ".bias"] = torch.zeros(d, device=device)
        for name in [k for k in shapes if k.startswith(pre)]:
            out_f, in_f = shapes[name]
            bound = (6.0 / (in_f + out_f)) ** 0.5
            p[name + ".weight"] = flat[at:at + out_f * in_f].view(
                out_f, in_f) * bound
            p[name + ".bias"] = torch.zeros(out_f, device=device)
            at += out_f * in_f
    p["ln_out.weight"] = torch.ones(d, device=device)
    p["ln_out.bias"] = torch.zeros(d, device=device)
    return p


def leaf_norms(tensors: Dict) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


class Run:
    """``fault`` plants a fault in the timed path (see ``FAULTS``)."""

    FAULTS = ("unchanged_state", "half_batch", "token_altered")

    def __init__(self, config: dict, mix: dict, seed: int, device: str = "cuda",
                 fault: Optional[str] = None):
        self.config, self.mix, self.seed, self.device = config, mix, seed, device
        self.model_cfg, self.train = config, config["training"]
        if fault is not None and fault not in self.FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.fault = fault
        self.B = mix["pairs_per_step"]
        self.L = self.model_cfg["max_position_embeddings"]

    # -- inputs --------------------------------------------------------------

    def make_inputs(self) -> None:
        mix = self.mix
        corpus, queries = synthetic_corpus(SyntheticSpec(
            n_docs=mix["pool_docs"], n_queries=mix["pool_pairs"],
            seed=self.seed % (2**31 - 1), hard=True))
        by_id = dict(zip(corpus.docids, corpus.texts))
        self.q_texts = queries.queries
        self.p_texts = [by_id[d] for d in queries.positive_docs]
        rng = np.random.RandomState(
            np.random.SeedSequence([self.seed, 3]).generate_state(1)[0])
        self.order = rng.permutation(len(self.q_texts))

    def rows(self, step: int) -> np.ndarray:
        n = len(self.order) // self.B
        s = (step % n) * self.B
        return self.order[s:s + self.B]

    def texts(self, step: int):
        r = self.rows(step)
        return [self.q_texts[i] for i in r], [self.p_texts[i] for i in r]

    def feed(self, step: int) -> Dict[str, np.ndarray]:
        """The step's batch as ``make_batches`` hashes it (no negatives)."""
        from tdr_torch.text.hash_tokenizer import encode_batch

        V = self.model_cfg["vocab_size"]
        q, p = self.texts(step)
        q_ids, q_mask = encode_batch(q, V, self.L)
        p_ids, p_mask = encode_batch(p, V, self.L)
        if self.fault == "token_altered":
            q_ids[:, 1] = np.where(q_mask[:, 1] > 0,
                                   2 + (q_ids[:, 1] - 1) % (V - 2), 0)
        return {"q_ids": q_ids, "q_mask": q_mask, "p_ids": p_ids,
                "p_mask": p_mask}

    # -- the program ---------------------------------------------------------

    def setup(self) -> None:
        import torch

        from tdr_torch.train import create_train_state, make_train_step
        from tdr_torch.utils.config import DenseConfig

        m, t = self.model_cfg, self.train
        marks = [time.perf_counter()]
        self.make_inputs()
        marks.append(time.perf_counter())
        self.p0 = make_weights(m, self.seed, self.device)
        cfg = DenseConfig(vocab_size=m["vocab_size"], dim=m["hidden_size"],
                          depth=m["num_hidden_layers"],
                          heads=m["num_attention_heads"],
                          mlp_ratio=m["intermediate_size"] / m["hidden_size"],
                          max_len=self.L, dtype=t["compute_dtype"])
        self.state = create_train_state(cfg, lr=t["lr"],
                                        weight_decay=t["weight_decay"],
                                        seed=0, device=self.device)
        self.state.model.load_state_dict(self.p0)
        self.step_fn = make_train_step(temperature=t["temperature"])
        marks.append(time.perf_counter())
        self.first_losses = []
        for i in range(self.mix["first_steps"]):
            loss = self.one_step(i)
            self.first_losses.append(float(loss))
            if i == 0:
                beta1 = self.state.optimizer.param_groups[0]["betas"][0]
                named = dict(self.state.model.named_parameters())
                held = self.state.optimizer.state
                self.grad1 = leaf_norms({
                    k: held.get(p, {}).get("exp_avg", torch.zeros_like(p))
                    / (1 - beta1) for k, p in named.items()})
        self.change = leaf_norms({
            k: v.detach() - self.p0[k]
            for k, v in self.state.model.named_parameters()})
        self.next_step = self.mix["first_steps"]
        if self.device != "cpu":
            torch.cuda.synchronize()
        marks.append(time.perf_counter())
        self.setup_parts = dict(zip(("inputs", "weights and state",
                                     "first steps"), np.diff(marks)))

    def one_step(self, i: int):
        batch = self.feed(i)
        if self.fault == "half_batch":
            batch = {k: v[: self.B // 2] for k, v in batch.items()}
        if self.fault == "unchanged_state":
            from tdr_torch.train.contrastive import batch_loss

            return batch_loss(self.state.model, batch,
                              self.train["temperature"])[0].detach()
        _, metrics = self.step_fn(self.state, batch)
        return metrics["loss"]

    # -- the window ----------------------------------------------------------

    def window(self, seconds: float, tracing: Optional[Tracing] = None
               ) -> None:
        import torch

        tracing = tracing or Tracing(False, seconds, seconds)
        self.losses: List = []
        self.traced_from = None
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            if tracing.due(time.perf_counter() - t0) and \
                    self.traced_from is None:
                self.traced_from = len(self.losses)
            with span("tdrbench.step"):
                self.losses.append(self.one_step(self.next_step))
            self.next_step += 1
        if self.device != "cpu":
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - t0

    def end_to_end(self) -> Dict[str, float]:
        tokens = 2 * self.B * self.L * len(self.losses)
        return {"train_tokens_per_s": tokens / self.window_s}

    def attempted_failed(self):
        vals = [float(x) for x in self.losses]
        return len(vals), sum(1 for v in vals if not np.isfinite(v))

    def release(self) -> None:
        self.state = self.step_fn = None
        gc.collect()
        if self.device != "cpu":
            import torch

            torch.cuda.empty_cache()

    # -- correctness ---------------------------------------------------------

    def reference_batches(self, n: int):
        import torch

        from tdrbench.reference.hashing import Hasher

        h = Hasher(self.model_cfg["vocab_size"], self.L)
        out = []
        for i in range(n):
            q, p = self.texts(i)
            (qi, qm), (pi, pm) = h.encode(q), h.encode(p)
            out.append(tuple(torch.as_tensor(x, device=self.device)
                             for x in (qi, qm, pi, pm)))
        return out

    def readings(self, rnd=None) -> Dict[str, tuple]:
        """The reference's readings of the first steps from the same weights
        and texts: each loss, the first gradient's norm and the change's
        norm after the last step, by leaf; ``rnd`` rounds its products (the
        control)."""
        from tdrbench.reference import encoder as ref

        n = self.mix["first_steps"]
        losses, g1, p_n = ref.follow(self.p0, self.reference_batches(n),
                                     self.model_cfg, self.train,
                                     rnd or ref.identity)
        r_g1 = leaf_norms(g1)
        r_change = leaf_norms({k: p_n[k] - self.p0[k] for k in p_n})
        return {"losses": losses, "grad1": r_g1, "change": r_change}

    def check(self, ref: Optional[dict] = None,
              prog: Optional[dict] = None) -> Dict[str, tuple]:
        """The numbers compared, each as (value, limit).  ``ref`` and
        ``prog`` default to the reference's readings and the program's;
        the control passes its own as ``prog``."""
        ref = ref or self.readings()
        prog = prog or {"losses": self.first_losses, "grad1": self.grad1,
                        "change": self.change}
        lim = self.mix["limits"]
        loss_gap = max(abs(a - b) / abs(b)
                       for a, b in zip(prog["losses"], ref["losses"]))
        med_g = statistics.median(ref["grad1"].values())
        grad_gap = max(abs(prog["grad1"][k] - g) / max(g, med_g)
                       for k, g in ref["grad1"].items())
        moved = [k for k, g in ref["grad1"].items() if g >= 1e-3 * med_g]
        self.left_out = sorted(set(ref["grad1"]) - set(moved))
        med_c = statistics.median(ref["change"][k] for k in moved)
        change_gap = max(abs(prog["change"][k] - ref["change"][k])
                         / max(ref["change"][k], med_c) for k in moved)
        return {"loss_gap": (loss_gap, lim["loss_gap"]),
                "grad_gap": (grad_gap, lim["grad_gap"]),
                "change_gap": (change_gap, lim["change_gap"])}

    def layer_inputs(self) -> Dict:
        """What the traced run's readers take: the steps completed in the
        traced part of the window and their model FLOPs
        (``arith.encoder_step_flops``)."""
        from tdrbench.harness import arith

        m = self.model_cfg
        return {"steps": len(self.losses) - self.traced_from,
                "step_flops": arith.encoder_step_flops(
                    2 * self.B, self.L, m["hidden_size"],
                    m["num_hidden_layers"]),
                "peak_flops": arith.PEAK_BF16_FLOPS}
