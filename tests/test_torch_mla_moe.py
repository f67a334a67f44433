"""The MLA + MoE encoder (``tdr_torch.models.mla_moe``) on the CPU, held to
the plain float32 reference (``tdrbench/reference/mla_moe.py``) at a small
size on seeded weights: embeddings, InfoNCE plus the balance loss, every
leaf's gradient and one AdamW step through ``make_train_step``, at f32
(tight) and bf16 (the stated tolerances); YaRN's frequencies and the
softmax scale at the published sizes; a fault in the mathematics fails;
the dispatch and combine gradients; the train state's device draw, the
sharded step's refusal, inference through ``encode`` and ``DenseModel``,
and the spans and counters a traced step records."""

import os
import sys

import numpy as np
import pytest

from tests.torch_threads import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from tdr_torch.models import mla_moe  # noqa: E402
from tdr_torch.train import contrastive as tc  # noqa: E402
from tdr_torch.utils import trace  # noqa: E402
from tdr_torch.utils.config import DenseConfig, MlaMoeConfig  # noqa: E402
from tdrbench.reference import mla_moe as ref  # noqa: E402

TEMP = 0.05
LR, WD = 2e-5, 0.01
ROPE = {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
        "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096,
        "type": "yarn"}
# hidden 64, 4 heads, nope 16, rope 8, v 16, latent 32, 8 experts top-2, 1
# shared, 1 dense + 2 MoE layers; L 16, B 4 pairs
REF_CFG = {"hidden_size": 64, "num_hidden_layers": 3, "num_attention_heads": 4,
           "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
           "v_head_dim": 16, "intermediate_size": 96,
           "moe_intermediate_size": 24, "n_routed_experts": 8,
           "n_shared_experts": 1, "num_experts_per_tok": 2,
           "first_k_dense_replace": 1, "rms_norm_eps": 1e-6,
           "rope_theta": 10000, "rope_scaling": ROPE, "vocab_size": 500,
           "aux_loss_alpha": 0.001}
L, B = 16, 4


def small(dtype="float32", **changes):
    kw = dict(vocab_size=500, dim=64, depth=3, heads=4, kv_lora_rank=32,
              qk_nope_dim=16, qk_rope_dim=8, v_dim=16, dense_hidden=96,
              n_experts=8, top_k=2, expert_hidden=24, n_shared=1, max_len=L,
              dtype=dtype)
    kw.update(changes)
    return MlaMoeConfig(**kw)


def batch(seed=0):
    """B (query, positive) pairs of L tokens, right-padded to 3..L valid."""
    g = np.random.RandomState(seed)
    ids = g.randint(2, 500, (2 * B, L))
    lens = g.randint(3, L + 1, 2 * B)
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.float32)
    ids = ids * mask.astype(np.int64)
    return {"q_ids": ids[:B], "q_mask": mask[:B], "p_ids": ids[B:],
            "p_mask": mask[B:]}


def as_tensors(b):
    return tuple(torch.as_tensor(b[k]) for k in
                 ("q_ids", "q_mask", "p_ids", "p_mask"))


def state(dtype, seed=3, **kw):
    st = tc.create_train_state(small(dtype, **kw), lr=LR, weight_decay=WD,
                               seed=seed, device="cpu")
    return st, {k: v.detach().clone()
                for k, v in st.model.named_parameters()}


# (embedding atol, relative loss gap, gradient gap over max(leaf, median
# leaf)): f32 sums in another order; bf16 products against f32 ones (the
# bf16 residual of each product, 2^-8 relative, through 3 layers)
TOL = {"float32": (1e-6, 1e-6, 1e-5), "bfloat16": (8e-3, 4e-3, 5e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_loss_and_gradient_match_the_reference(dtype):
    st, p0 = state(dtype)
    b = batch()
    qi, qm, pi, pm = as_tensors(b)
    emb_tol, loss_tol, grad_tol = TOL[dtype]
    with ref.ieee_f32():
        want, bal = ref.encode(p0, torch.cat([qi, pi]), torch.cat([qm, pm]),
                               REF_CFG)
        r_loss, r_grads = ref.loss_and_grad(p0, (qi, qm, pi, pm), REF_CFG,
                                            TEMP, chunk=3)
    with torch.no_grad():
        got, aux = st.model.forward_with_aux(torch.cat([qi, pi]),
                                             torch.cat([qm, pm]))
    torch.testing.assert_close(got, want, rtol=0, atol=emb_tol)
    assert float(aux) == pytest.approx(float(bal.mean()), rel=loss_tol)
    loss, metrics = tc.batch_loss(st.model, b, TEMP)
    assert float(metrics["aux_loss"]) > 0
    assert float(loss.detach()) == pytest.approx(r_loss, rel=loss_tol)
    loss.backward()
    med = torch.stack([g.abs().max() for g in r_grads.values()]).median()
    for k, p in st.model.named_parameters():
        scale = torch.maximum(r_grads[k].abs().max(), med)
        assert float((p.grad - r_grads[k]).abs().max() / scale) <= grad_tol, k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_adamw_step_matches_the_reference(dtype):
    """One step of ``make_train_step`` against the reference's gradient and
    AdamW: the change of every leaf, by norm, over max(its norm, the
    median leaf's), within 1e-4 at f32 and 5% at bf16 (an entry whose
    gradient is near 0 moves by up to lr either way)."""
    st, p0 = state(dtype)
    tc.make_train_step(TEMP)(st, batch(1))
    qi, qm, pi, pm = as_tensors(batch(1))
    p = {k: v.clone() for k, v in p0.items()}
    with ref.ieee_f32():
        _, g = ref.loss_and_grad(p, (qi, qm, pi, pm), REF_CFG, TEMP, chunk=3)
    ref.AdamW(p, LR, WD).step(p, g)
    want = {k: float((p[k] - p0[k]).norm()) for k in p}
    med = float(np.median(list(want.values())))
    tol = 1e-4 if dtype == "float32" else 0.05
    for k, v in st.model.named_parameters():
        got = float((v.detach() - p0[k]).norm())
        assert abs(got - want[k]) <= tol * max(want[k], med), k


def test_yarn_at_the_published_sizes():
    cfg = MlaMoeConfig()
    inv = mla_moe.yarn_inv_freq(cfg)
    extra = 10000.0 ** (-torch.arange(0, 64, 2, dtype=torch.float64) / 64)
    # the ramp runs from dim pair 10 (all base frequency) to 23 (all
    # interpolated, a fortieth)
    torch.testing.assert_close(inv[:11], extra[:11], rtol=1e-15, atol=0)
    torch.testing.assert_close(inv[23:], extra[23:] / 40, rtol=1e-15, atol=0)
    m = 1 - (torch.arange(11, 23, dtype=torch.float64) - 10) / 13
    torch.testing.assert_close(inv[11:23], extra[11:23] * m
                               + extra[11:23] / 40 * (1 - m))
    published = dict(REF_CFG, qk_rope_head_dim=64, qk_nope_head_dim=128)
    torch.testing.assert_close(inv, ref.yarn_freqs(published))
    assert mla_moe.softmax_scale(cfg) == pytest.approx(0.1147214, abs=1e-7)
    assert ref.scale(published) == pytest.approx(0.1147214, abs=1e-7)
    cos, sin = mla_moe.rope_tables(cfg, 4, "cpu")
    torch.testing.assert_close(cos ** 2 + sin ** 2, torch.ones(4, 32))


@pytest.mark.parametrize("fault", [dict(top_k=1), dict(n_shared=0),
                                   dict(mscale_all_dim=0.0)],
                         ids=["top_k_one_short", "no_shared", "no_mscale"])
def test_a_fault_in_the_mathematics_fails(fault):
    """The port with one expert a token fewer, without its shared experts,
    or without YaRN's mscale, against the published reference: its f32
    embeddings fall 100 times outside the sound f32 port's tolerance (at
    this width the scores are small and the softmax near uniform, so the
    mscale's 1.59x moves the embeddings by ~5e-3 only; the card's cell
    calibrates each fault at the published width)."""
    st, p0 = state("float32", **fault)
    full = state("float32")[1]
    with torch.no_grad():
        for k, v in st.model.named_parameters():
            v.copy_(full[k])
    qi, qm, pi, pm = as_tensors(batch())
    ids, mask = torch.cat([qi, pi]), torch.cat([qm, pm])
    with ref.ieee_f32():
        want, _ = ref.encode(full, ids, mask, REF_CFG)
    with torch.no_grad():
        got = st.model(ids, mask)
    assert float((got - want).abs().max()) > 100 * TOL["float32"][0]


def test_grouped_product_plain_takes_each_experts_rows():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(12, 5, generator=g)
    w = torch.randn(4, 3, 5, generator=g)
    ends = torch.tensor([3, 3, 7, 10])            # expert 1 empty, 2 rows past
    out = mla_moe.grouped_product_plain(x, w, ends)
    want = torch.cat([x[0:3] @ w[0].T, x[3:7] @ w[2].T, x[7:10] @ w[3].T,
                      torch.zeros(2, 3)])
    torch.testing.assert_close(out, want)


def test_the_backward_casts_the_expert_stacks_again():
    """The grouped product saves no cast of the f32 stack for its backward
    but casts it again there: gradients bit for bit those of the product
    of a kept cast."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn(12, 5, generator=g).bfloat16()
    w = torch.randn(4, 3, 5, generator=g)
    dy = torch.randn(12, 3, generator=g).bfloat16()
    ends = torch.tensor([3, 3, 7, 10])
    grads = []
    for fn in (lambda x, w: mla_moe.grouped_product(x, w, ends,
                                                    torch.bfloat16),
               lambda x, w: mla_moe.grouped_product_plain(
                   x, w.to(torch.bfloat16), ends)):
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        out = fn(xr, wr)
        out.backward(dy)
        grads.append((out.detach(), xr.grad, wr.grad))
    for got, want in zip(*grads):
        assert torch.equal(got, want)


def test_dispatch_and_combine_gradients():
    """The permutation to expert order and the weighted combine back, in
    f64 against finite differences."""
    g = torch.Generator().manual_seed(1)
    N, k, D = 5, 3, 4
    order = torch.randperm(N * k, generator=g)
    y = torch.randn(N, D, dtype=torch.float64, generator=g,
                    requires_grad=True)
    rows = torch.randn(N * k, D, dtype=torch.float64, generator=g,
                       requires_grad=True)
    w = torch.rand(N, k, dtype=torch.float64, generator=g, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda y: mla_moe._Dispatch.apply(y, order, k, torch.float64), (y,))
    assert torch.autograd.gradcheck(
        lambda r, w: mla_moe._Combine.apply(r, w, order), (rows, w))
    x = mla_moe._Dispatch.apply(y, order, k, torch.float64)
    torch.testing.assert_close(x, y.repeat_interleave(k, 0)[order])
    back = mla_moe._Combine.apply(rows, w, order)
    unsorted = torch.empty_like(rows)
    unsorted[order] = rows
    torch.testing.assert_close(back, (unsorted.view(N, k, D)
                                      * w[..., None]).sum(1))


def test_train_state_is_drawn_on_its_device_from_the_seed():
    a = mla_moe.init_mla_moe(small(), seed=5, device="cpu")
    b = mla_moe.init_mla_moe(small(), seed=5, device="cpu")
    c = mla_moe.init_mla_moe(small(), seed=6, device="cpu")
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                                  c.parameters()):
        assert torch.equal(pa, pb)
        if name.endswith("norm.weight"):
            assert torch.equal(pa, torch.ones_like(pa))
        else:
            assert not torch.equal(pa, pc)
            assert float(pa.detach().std()) == pytest.approx(0.02, rel=0.5)
    st, _ = state("float32")
    assert isinstance(st.model, mla_moe.MlaMoeEncoder)
    assert isinstance(st.optimizer, torch.optim.AdamW)


def test_the_sharded_step_refuses_it():
    from tdr_torch.parallel.mesh import make_mesh

    st, _ = state("float32")
    with pytest.raises(TypeError, match="DualEncoder"):
        tc.shard_train_state(make_mesh(devices=["cpu"] * 2, data=2), st)


def test_inference_through_encode_and_dense_model():
    from tdr_torch.models.dense import DenseModel
    from tdr_torch.models.encoder import encode

    st, _ = state("float32")
    qi, qm, _, _ = as_tensors(batch())
    emb = encode(st.model, qi.numpy(), qm.numpy())
    torch.testing.assert_close(emb.norm(dim=-1), torch.ones(B))
    texts = [f"document {i} about topic {i % 3}" for i in range(12)]
    dense = DenseModel.build(st.model, DenseConfig(vocab_size=500, dim=64,
                                                   max_len=L), texts,
                             [f"d{i}" for i in range(12)], batch=8)
    hits = dense.retrieve(texts[:3], k=1)
    assert [h[0] for h in hits] == ["d0", "d1", "d2"]


def test_a_train_step_after_inference_on_the_same_model():
    """``encode`` runs the first forward in inference mode; the rope tables
    it makes are kept, and the train step after it saves them for its
    backward."""
    from tdr_torch.models.encoder import encode

    st, p0 = state("float32")
    qi, qm, _, _ = as_tensors(batch())
    encode(st.model, qi.numpy(), qm.numpy())
    _, metrics = tc.make_train_step(TEMP)(st, batch())
    assert np.isfinite(float(metrics["loss"]))
    assert all(not torch.equal(p.detach(), p0[k])
               for k, p in st.model.named_parameters())


def test_a_traced_step_records_the_spans_and_counters():
    st, _ = state("bfloat16")
    step = tc.make_train_step(TEMP)
    trace.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(st, batch())
    names = [e.name for e in prof.events()]
    n_moe = 2
    for span in ("tdr_torch.mla.attend", "tdr_torch.moe.route",
                 "tdr_torch.moe.experts", "tdr_torch.moe.shared"):
        want = 3 if span == "tdr_torch.mla.attend" else n_moe
        assert names.count(span) == want, span
    assert not [n for n in names if n.startswith("tdr_torch.sync.")
                and n != "tdr_torch.sync.batch_h2d"]
    assert trace.counters["moe.tokens"] == n_moe * 2 * B * L
    assert trace.counters["moe.assignments"] == 2 * trace.counters["moe.tokens"]
    trace.reset_counters()
