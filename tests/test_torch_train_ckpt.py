"""Train-state checkpoints across the two packages, on CPU.

``save_train_state`` writes jax's flattened ``TrainState`` leaves (params in
flax's sorted-key order, optax's count, mu, nu, the step) in both packages,
so each resumes from the other's file:

* ``tdr`` saves after 2 steps, the port loads and takes a third, which
  agrees with ``tdr``'s third step within the f32 train step's tolerance
  (``tests/test_torch_train.py``: 3e-5, the key biases within Adam's bound);
* the port saves and ``tdr.ckpt.load_train_state`` restores every leaf bit
  for bit;
* in the port, 2 steps + save + load + 2 steps equals 4 straight steps bit
  for bit.
"""

import json
import os

import numpy as np
import pytest

from tests.torch_threads import torch

import flax  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tdr.ckpt import registry as jreg  # noqa: E402
from tdr.train import contrastive as jc  # noqa: E402
from tdr.utils.config import DenseConfig as JDenseConfig  # noqa: E402
from tdr_torch.ckpt import load_train_state, save_train_state  # noqa: E402
from tdr_torch.models import encoder as tenc  # noqa: E402
from tdr_torch.train import contrastive as tc  # noqa: E402
from tdr_torch.utils.config import DenseConfig  # noqa: E402

SMALL = dict(vocab_size=200, dim=32, depth=2, heads=4, max_len=12,
             dtype="float32")
LR = 1e-3


def _unbox(tree):
    return jax.tree_util.tree_map(np.asarray, flax.linen.meta.unbox(tree))


def _batch(seed, B=6, Nn=2, L=12, V=200):
    r = np.random.RandomState(seed)
    out = {}
    for k, shp in (("q", (B, L)), ("p", (B, L)), ("n", (B, Nn, L))):
        lens = r.randint(2, L + 1, size=shp[:-1])
        mask = (np.arange(L) < lens[..., None]).astype(np.float32)
        ids = r.randint(0, V, size=shp).astype(np.int32)
        out[f"{k}_ids"] = ids * mask.astype(np.int32)
        out[f"{k}_mask"] = mask
    return out


def _fresh(seed=0):
    return tc.create_train_state(DenseConfig(**SMALL), lr=LR, seed=seed,
                                 device="cpu")


def _steps(ts, seeds):
    step = tc.make_train_step()
    for s in seeds:
        ts, _ = step(ts, _batch(s))
    return ts


def test_jax_saves_port_resumes(tmp_path):
    model, js, tx = jc.create_train_state(JDenseConfig(**SMALL), lr=LR)
    step = jc.make_train_step(model, tx)
    for s in (0, 1):
        js, _ = step(js, {k: jnp.asarray(v) for k, v in _batch(s).items()})
    jreg.save_train_state(str(tmp_path), js)
    ts = load_train_state(str(tmp_path), _fresh(seed=9))
    assert ts.step == 2
    count, mu, _ = tc.adam_moments(ts)
    adam = _unbox(js.opt_state)[0]
    assert count == 2
    for name, v in tenc.encoder_state_from_flax(adam.mu).items():
        assert torch.equal(mu[name], v), name
    for name, v in tenc.encoder_state_from_flax(_unbox(js.params)).items():
        assert torch.equal(ts.model.state_dict()[name], v), name

    js, _ = step(js, {k: jnp.asarray(v) for k, v in _batch(2).items()})
    ts = _steps(ts, [2])
    jp = tenc.encoder_state_from_flax(_unbox(js.params))
    for name, p in ts.model.named_parameters():
        d = np.abs(p.detach().numpy() - jp[name].numpy()).max()
        limit = 2 * 1.004 * LR if name.endswith("attn.key.bias") else 3e-5
        assert d <= limit, (name, d)


def test_port_saves_jax_loads(tmp_path):
    ts = _steps(_fresh(), [0, 1, 2])
    save_train_state(str(tmp_path), ts)
    with open(tmp_path / "meta.json") as f:
        meta = json.load(f)
    _, template, _ = jc.create_train_state(JDenseConfig(**SMALL), lr=LR)
    restored = jreg.load_train_state(str(tmp_path), template)
    assert int(restored.step) == 3
    adam = _unbox(restored.opt_state)[0]
    assert int(adam.count) == 3 and adam.count.dtype == np.int32
    count, mu, nu = tc.adam_moments(ts)
    for ours, theirs in ((ts.model.state_dict(), restored.params),
                         (mu, adam.mu), (nu, adam.nu)):
        theirs = tenc.encoder_state_from_flax(_unbox(theirs))
        assert ours.keys() == theirs.keys()
        for name in ours:
            assert torch.equal(ours[name], theirs[name]), name
    flat, _ = jax.tree_util.tree_flatten(template)
    assert meta["n_leaves"] == len(flat)
    # and the JAX side steps on from it
    model, _, tx = jc.create_train_state(JDenseConfig(**SMALL), lr=LR)
    restored, m = jc.make_train_step(model, tx)(
        restored, {k: jnp.asarray(v) for k, v in _batch(3).items()})
    assert int(restored.step) == 4 and np.isfinite(float(m["loss"]))


def test_resume_equals_straight_training(tmp_path):
    straight = _steps(_fresh(), [0, 1, 2, 3])
    half = _steps(_fresh(), [0, 1])
    save_train_state(str(tmp_path), half)
    resumed = _steps(load_train_state(str(tmp_path), _fresh(seed=5)), [2, 3])
    assert resumed.step == straight.step == 4
    a, b = straight.model.state_dict(), resumed.model.state_dict()
    for name in a:
        assert torch.equal(a[name], b[name]), name
    for x, y in zip(tc.adam_moments(straight)[1:], tc.adam_moments(resumed)[1:]):
        for name in x:
            assert torch.equal(x[name], y[name]), name


def test_fresh_state_round_trip_and_mismatch(tmp_path):
    fresh = _fresh()
    save_train_state(str(tmp_path / "a"), fresh)
    back = load_train_state(str(tmp_path / "a"), _fresh(seed=3))
    assert back.step == 0 and tc.adam_moments(back)[0] == 0
    # a fresh save steps on exactly as the fresh state does
    a = _steps(fresh, [0])
    b = _steps(back, [0])
    for name, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[name]), name
    other = tc.create_train_state(DenseConfig(**dict(SMALL, depth=1)),
                                  device="cpu")
    with pytest.raises(ValueError, match="config mismatch"):
        load_train_state(str(tmp_path / "a"), other)
    wide = tc.create_train_state(DenseConfig(**dict(SMALL, dim=64)),
                                 device="cpu")
    with pytest.raises(ValueError, match="expected"):
        load_train_state(str(tmp_path / "a"), wide)
    assert os.path.exists(tmp_path / "a" / "train_state.npz")
