"""The port's contrastive trainer against the JAX package, on CPU.

The encoder runs at a small width (vocab 300, dim 64, depth 2, 4 heads, 16
tokens).  ``tdr``'s flax init and optax state are carried across with
``train_state_from_optax``, so both packages step from the same point on
the same seeded batches.

Tolerances, and why:

* ``contrastive_loss``: value and gradients within rtol 1e-6 (f32).
* f32 train step: one step's gradients within 1e-5 of each leaf's largest
  entry; params after 3 steps within 3e-5 (1% of lr a step).  The
  attention *key* biases are held apart: softmax is blind to a constant
  added to a query's logits, so their true gradient is zero and both
  packages compute rounding noise (held below 1e-6 of the largest
  gradient at f32, 1e-2 at bf16).  Adam divides each update by its own
  gradient's size, so a noise gradient still moves them by up to lr a
  step, in either package in its own direction: held to Adam's bound,
  2 x 1.004 x lr a step apart.
* bf16 train step: both round at the same points, but sum in other orders,
  and the loss divides cosines by the temperature 0.05.  The loss within
  1e-2 relative; each gradient leaf at a cosine of at least 0.999 and a
  norm within 2%; after 3 steps 99% of the entries within lr / 4 and
  every entry within Adam's bound.
* The embedding gradient (fault C5 in ROADMAP.md): flax's ``nn.Embed(dtype=
  bf16)`` casts the table and then gathers, so its backward accumulates
  the bf16 cotangents of a repeated id in bf16.  The port gathers in f32
  and casts (the same forward values) and accumulates in f32.  Held: the
  port within the f32 summation bound n 2**-24 sum|g| of the exact sum,
  ``tdr`` within the bf16 one (n - 1) 2**-8 sum|g|.  At f32 there is no
  such point and the gradient is held tight on a batch of repeated ids.
* AdamW against optax from the same state and gradients: params within
  2e-7 (the same update in another order).
"""

import numpy as np
import pytest

from tests.torch_threads import torch

import flax  # noqa: E402
import flax.linen as nn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tdr.data import SyntheticSpec, synthetic_corpus  # noqa: E402
from tdr.train import contrastive as jc  # noqa: E402
from tdr.train.mining import make_pseudo_queries  # noqa: E402
from tdr.utils.config import DenseConfig as JDenseConfig  # noqa: E402
from tdr_torch.data.loaders import QuerySet  # noqa: E402
from tdr_torch.models import encoder as tenc  # noqa: E402
from tdr_torch.train import contrastive as tc  # noqa: E402
from tdr_torch.utils.config import DenseConfig  # noqa: E402

SMALL = dict(vocab_size=300, dim=64, depth=2, heads=4, max_len=16)
LR = 1e-3
ADAM_STEP = 1.004 * LR          # Adam's largest update in 3 steps (b1, b2)


def _unbox(tree):
    return jax.tree_util.tree_map(np.asarray, flax.linen.meta.unbox(tree))


def _carried(dtype, seed=0):
    """(flax model, optax tx, jax TrainState, the port's TrainState at the
    same weights and moments)."""
    model, state, tx = jc.create_train_state(
        JDenseConfig(**SMALL, dtype=dtype), lr=LR, seed=seed)
    ts = tc.train_state_from_optax(
        _unbox(state.params), _unbox(state.opt_state), 0,
        DenseConfig(**SMALL, dtype=dtype), LR, device="cpu")
    return model, tx, state, ts


def _batch(seed, B=8, Nn=2, L=16, V=300, repeat=None):
    r = np.random.RandomState(seed)
    out = {}
    for k, shp in (("q", (B, L)), ("p", (B, L)), ("n", (B, Nn, L))):
        ids = r.randint(0, V, size=shp).astype(np.int32)
        if repeat is not None:
            ids[..., ::2] = repeat          # one id at half the positions
        lens = r.randint(2, L + 1, size=shp[:-1])
        mask = (np.arange(L) < lens[..., None]).astype(np.float32)
        out[f"{k}_ids"], out[f"{k}_mask"] = ids * mask.astype(np.int32), mask
    return out


def _jax_loss(model, params, batch):
    q = model.apply({"params": params}, batch["q_ids"], batch["q_mask"])
    p = model.apply({"params": params}, batch["p_ids"], batch["p_mask"])
    B, Nn, L = batch["n_ids"].shape
    n = model.apply({"params": params}, batch["n_ids"].reshape(B * Nn, L),
                    batch["n_mask"].reshape(B * Nn, L)).reshape(B, Nn, -1)
    return jc.contrastive_loss(q, p, n)[0]


def _jax_grad_tree(model, params, batch):
    fn = jax.jit(jax.value_and_grad(lambda p, b: _jax_loss(model, p, b)))
    return fn(params, {k: jnp.asarray(v) for k, v in batch.items()})


def _jax_grads(model, params, batch):
    loss, g = _jax_grad_tree(model, params, batch)
    return float(loss), {k: v.numpy() for k, v in
                         tenc.encoder_state_from_flax(_unbox(g)).items()}


def _port_grads(ts, batch):
    loss, _ = tc.batch_loss(ts.model, batch)
    ts.model.zero_grad(set_to_none=True)
    loss.backward()
    return loss.item(), {k: p.grad.numpy().copy()
                         for k, p in ts.model.named_parameters()}


def _is_key_bias(name):
    return name.endswith("attn.key.bias")


# -- the loss ---------------------------------------------------------------------

@pytest.mark.parametrize("with_neg", [False, True])
def test_contrastive_loss_matches_jax(with_neg):
    rng = np.random.RandomState(4)

    def unit(*shape):
        x = rng.randn(*shape).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    q, p, n = unit(12, 32), unit(12, 32), unit(12, 3, 32)
    args = (q, p, n) if with_neg else (q, p)

    def jl(*a):
        return jc.contrastive_loss(*a)[0]

    j_loss, j_m = jc.contrastive_loss(*map(jnp.asarray, args))
    j_grads = jax.grad(jl, argnums=tuple(range(len(args))))(
        *map(jnp.asarray, args))
    t_args = [torch.tensor(a, requires_grad=True) for a in args]
    t_loss, t_m = tc.contrastive_loss(*t_args)
    t_loss.backward()
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=1e-6)
    assert t_m["accuracy"].item() == float(j_m["accuracy"])
    assert t_m["loss"].item() == t_loss.item() and not t_m["loss"].requires_grad
    for ta, jg in zip(t_args, j_grads):
        np.testing.assert_allclose(ta.grad.numpy(), np.asarray(jg), rtol=1e-6,
                                   atol=1e-6 * np.abs(np.asarray(jg)).max())


# -- the train step ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_matches_jax(dtype):
    model, tx, js, ts = _carried(dtype)
    jloss, jg = _jax_grads(model, js.params, _batch(0))
    tloss, tg = _port_grads(ts, _batch(0))
    top = max(np.abs(g).max() for g in jg.values())
    assert tg.keys() == jg.keys()
    if dtype == "float32":
        np.testing.assert_allclose(tloss, jloss, rtol=1e-6)
    else:
        np.testing.assert_allclose(tloss, jloss, rtol=1e-2)
    for name, g in tg.items():
        r = jg[name]
        if _is_key_bias(name):
            # the true gradient is zero: rounding noise on both sides
            tol = 1e-6 if dtype == "float32" else 1e-2
            assert np.abs(g).max() <= tol * top
            assert np.abs(r).max() <= tol * top
        elif dtype == "float32":
            np.testing.assert_allclose(g, r, rtol=1e-5,
                                       atol=1e-5 * np.abs(r).max(),
                                       err_msg=name)
        else:
            cos = (g * r).sum() / np.linalg.norm(g) / np.linalg.norm(r)
            assert cos >= 0.999, (name, cos)
            assert abs(np.linalg.norm(g) / np.linalg.norm(r) - 1) <= 0.02, name

    step = jc.make_train_step(model, tx)
    tstep = tc.make_train_step()
    ts.model.zero_grad(set_to_none=True)
    for i in range(3):
        b = _batch(10 + i)
        js, jm = step(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tm = tstep(ts, b)
        rtol = 1e-5 if dtype == "float32" else 1e-2
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=rtol)
    assert ts.step == int(js.step) == 3
    jp = tenc.encoder_state_from_flax(_unbox(js.params))
    rest = []
    for name, p in ts.model.named_parameters():
        d = np.abs(p.detach().numpy() - jp[name].numpy())
        assert d.max() <= 2 * 3 * ADAM_STEP, name
        if _is_key_bias(name):
            continue
        rest.append(d.reshape(-1))
        if dtype == "float32":
            assert d.max() <= 3e-5, (name, d.max())
    if dtype == "bfloat16":
        assert np.quantile(np.concatenate(rest), 0.99) <= LR / 4


def test_embedding_gradient_rounding_point():
    """The bf16 embedding's backward on 40 x 100 positions, 1,000 of them
    one id: the port sums the cotangents in f32, ``tdr`` in bf16."""
    V, D = 50, 64
    r = np.random.RandomState(0)
    ids = np.concatenate([np.zeros(1000, np.int32),
                          r.randint(0, V, 3000).astype(np.int32)]).reshape(40, 100)
    table = (r.randn(V, D) * 0.02).astype(np.float32)
    g = np.asarray(jnp.asarray(r.randn(40, 100, D), jnp.bfloat16)
                   .astype(jnp.float32))            # bf16 cotangents
    emb = nn.Embed(V, D, dtype=jnp.bfloat16)
    _, vjp = jax.vjp(lambda t: emb.apply({"params": {"embedding": t}}, ids),
                     jnp.asarray(table))
    j = np.asarray(vjp(jnp.asarray(g, jnp.bfloat16))[0])

    model = tenc.DualEncoder(DenseConfig(vocab_size=V, dim=D, depth=0,
                                         heads=1, max_len=100))
    model.tok_embed.weight.data = torch.from_numpy(table)
    out = model.tok_embed(torch.from_numpy(ids).long()).to(torch.bfloat16)
    out.backward(torch.from_numpy(g).to(torch.bfloat16))
    t = model.tok_embed.weight.grad.numpy()

    flat = ids.reshape(-1)
    exact = np.zeros((V, D))
    np.add.at(exact, flat, g.reshape(-1, D).astype(np.float64))
    mag = np.zeros((V, D))
    np.add.at(mag, flat, np.abs(g.reshape(-1, D)).astype(np.float64))
    n = np.bincount(flat, minlength=V)[:, None]
    assert np.all(np.abs(t - exact) <= n * 2.0 ** -24 * mag)
    assert np.all(np.abs(j - exact) <= (n - 1) * 2.0 ** -8 * mag + 1e-30)
    # the two differ where ids repeat: most at the 1,000-fold id
    assert np.abs(t - j)[0].max() > 100 * np.abs(t - exact)[0].max()


def test_f32_embedding_gradient_with_repeated_ids():
    model, tx, js, ts = _carried("float32", seed=1)
    b = _batch(5, repeat=7)
    _, jg = _jax_grads(model, js.params, b)
    _, tg = _port_grads(ts, b)
    r, g = jg["tok_embed.weight"], tg["tok_embed.weight"]
    assert np.abs(r[7]).max() > 10 * np.median(np.abs(r[r != 0]))
    np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5 * np.abs(r).max())


def test_adamw_step_matches_optax_from_one_state():
    """torch's AdamW from optax's state after 2 steps, with the same
    gradients: exp_avg is mu, exp_avg_sq is nu, every param's step is count."""
    model, tx, js, _ = _carried("float32", seed=2)
    step = jc.make_train_step(model, tx)
    for i in range(2):
        js, _ = step(js, {k: jnp.asarray(v) for k, v in _batch(20 + i).items()})
    cfg = DenseConfig(**SMALL)
    ts = tc.train_state_from_optax(_unbox(js.params), _unbox(js.opt_state),
                                   int(js.step), cfg, LR, device="cpu")
    adam = _unbox(js.opt_state)[0]
    mu, nu = (tenc.encoder_state_from_flax(x) for x in (adam.mu, adam.nu))
    count, t_mu, t_nu = tc.adam_moments(ts)
    assert count == int(adam.count) == ts.step == 2
    for name, p in ts.model.named_parameters():
        st = ts.optimizer.state[p]
        assert torch.equal(st["exp_avg"], mu[name]) and torch.equal(
            t_mu[name], mu[name])
        assert torch.equal(st["exp_avg_sq"], nu[name]) and torch.equal(
            t_nu[name], nu[name])
        assert st["step"].item() == 2.0
    group = ts.optimizer.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) \
        == (LR, (0.9, 0.999), 1e-8, 0.01)
    assert len(group["params"]) == len(list(ts.model.parameters()))

    params = js.params
    _, g_tree = _jax_grad_tree(model, params, _batch(30))
    updates, _ = tx.update(g_tree, js.opt_state, params)
    new = tenc.encoder_state_from_flax(_unbox(
        jax.tree_util.tree_map(lambda a, u: a + u, params, updates)))
    grads = tenc.encoder_state_from_flax(_unbox(g_tree))
    for name, p in ts.model.named_parameters():
        p.grad = grads[name]
    ts.optimizer.step()
    for name, p in ts.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), new[name].numpy(),
                                   rtol=0, atol=2e-7, err_msg=name)



def test_train_step_holds_ieee_f32_through_backward(monkeypatch):
    """With TF32 asked for by the caller, the backward's products and the
    optimizer update still run under the IEEE f32 pin; the caller's setting
    is back after the step."""
    _, _, _, ts = _carried("float32", seed=3)
    seen = []
    for p in ts.model.parameters():
        p.register_hook(lambda g: seen.append(
            torch.get_float32_matmul_precision()) or g)
    ts.optimizer.register_step_pre_hook(lambda *a: seen.append(
        torch.get_float32_matmul_precision()))
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        tc.make_train_step()(ts, _batch(6))
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(before)
    assert len(seen) == len(list(ts.model.parameters())) + 1
    assert set(seen) == {"highest"}


# -- the data pipeline and the loop -------------------------------------------------

def _world():
    corpus, queries = synthetic_corpus(SyntheticSpec(
        n_docs=120, n_queries=30, seed=3, ref_proportions=False,
        langs=("en", "de")))
    pqs = make_pseudo_queries(corpus, 40, seed=2)
    qs = QuerySet(pqs.query_ids, pqs.queries, pqs.langs, pqs.positive_docs,
                  [[corpus.docids[(i * 7) % 120], "missing-doc"][: i % 3]
                   for i in range(len(pqs.queries))])
    return corpus, qs


def test_make_batches_bit_equal():
    corpus, qs = _world()
    by_id = dict(zip(corpus.docids, corpus.texts))
    for cfg, bs, n_neg, seed in ((SMALL, 8, 2, 0), (dict(SMALL, max_len=32),
                                                    12, 3, 5)):
        j = list(jc.make_batches(qs, by_id, JDenseConfig(**cfg), bs, n_neg,
                                 seed=seed))
        t = list(tc.make_batches(qs, by_id, DenseConfig(**cfg), bs, n_neg,
                                 seed=seed))
        assert len(t) == len(j) == len(qs.queries) // bs
        for a, b in zip(t, j):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k])


def test_loss_curve_matches_jax(monkeypatch):
    """``train_dense_retriever`` in both packages from the same carried init
    over the same batches: the per-epoch losses agree (f32)."""
    corpus, qs = _world()
    model, tx, js, ts = _carried("float32", seed=4)
    monkeypatch.setattr(jc, "create_train_state",
                        lambda cfg, lr, seed: (model, js, tx))
    monkeypatch.setattr(tc, "create_train_state",
                        lambda cfg, lr, seed, device: ts)
    cfg = dict(SMALL, dtype="float32")
    _, _, jlast = jc.train_dense_retriever(corpus, qs, JDenseConfig(**cfg),
                                           epochs=3, batch_size=8, lr=LR)
    tmodel, tstate, tlast = tc.train_dense_retriever(
        corpus, qs, DenseConfig(**cfg), epochs=3, batch_size=8, lr=LR,
        device="cpu")
    assert tmodel is ts.model and tstate.step == 15
    assert len(tlast["loss_curve"]) == len(jlast["loss_curve"]) == 3
    np.testing.assert_allclose(tlast["loss_curve"], jlast["loss_curve"],
                               atol=2e-4)
    np.testing.assert_allclose(tlast["loss"], jlast["loss"], rtol=1e-4)
    assert tlast["accuracy"] == jlast["accuracy"]


def test_train_dense_retriever_defaults_and_empty_epoch():
    corpus, qs = _world()
    cfg = DenseConfig(**SMALL)
    model, state, last = tc.train_dense_retriever(
        corpus, qs, cfg, epochs=2, batch_size=10, lr=LR, device="cpu")
    assert state.step == 8 and len(last["loss_curve"]) == 2
    assert all(np.isfinite(last["loss_curve"]))
    # too few usable pairs for one batch: no step, an empty curve
    _, state, last = tc.train_dense_retriever(
        corpus, qs, cfg, epochs=2, batch_size=1000, device="cpu")
    assert state.step == 0 and last == {"loss_curve": []}


def test_create_train_state_device_rule(monkeypatch):
    st = tc.create_train_state(DenseConfig(**SMALL), lr=2e-3, seed=1,
                               device="cpu")
    ref = tenc.init_encoder(DenseConfig(**SMALL), seed=1, device="cpu")
    for (k, a), b in zip(st.model.state_dict().items(),
                         ref.state_dict().values()):
        assert torch.equal(a, b), k
    g = st.optimizer.param_groups[0]
    assert (g["lr"], g["weight_decay"], st.step) == (2e-3, 0.01, 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tc.create_train_state(DenseConfig(**SMALL))
