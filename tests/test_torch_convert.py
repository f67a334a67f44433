"""The port's HF BERT encoder (``tdr_torch.models.convert``) against the JAX
package's flax ``BertEncoder`` and against ``transformers.BertModel``, on
CPU, at the small config of tests/test_convert.py.

Weights cross with ``bert_state_from_flax`` (flax → port) and
``convert_hf_bert`` (HF → port, HF → flax): f32 forwards agree within atol
1e-5, bf16 forwards within cosine 0.999.  ``load_sentence_transformer``
reads checkpoint files the test writes itself (no download); the port reads
``model.safetensors`` with its own reader, since the card's machine has no
``safetensors`` package.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from tests.torch_threads import torch
transformers = pytest.importorskip("transformers")

import flax  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tdr.models import convert as jconv  # noqa: E402
from tdr.models import dense as jdense  # noqa: E402
from tdr.utils.config import DenseConfig as JDenseConfig  # noqa: E402
from tdr_torch.models import convert as tconv  # noqa: E402
from tdr_torch.models import dense as tdense  # noqa: E402
from tdr_torch.models import encoder as tenc  # noqa: E402
from tdr_torch.utils.config import DenseConfig  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = dict(vocab_size=120, dim=32, depth=2, heads=4, mlp_hidden=64,
              max_len=24, type_vocab_size=2)
JCFG = jconv.BertConfig(**FIELDS)
TCFG = tconv.BertConfig(**FIELDS)
PREFIXES = ("0.auto_model.", "auto_model.", "bert.")

DOCS = [
    "alpine glaciers retreat meltwater lakes survey",
    "honeybees pollinate orchards nectar hives spring",
    "quantum qubits superposition interference algorithms",
    "printing press movable type books literacy europe",
    "coral reefs bleaching warm seawater symbiotic algae",
    "aqueduct arches stone gradient fountains roman",
    "volcanic ash plume jet engines aviation reroute",
    "desalination reverse osmosis membranes seawater pressure",
]


def _inputs(B=6, L=16, seed=0):
    """Seeded ids with ragged masks, a CLS-only row (an empty text) and a
    row with no valid token."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, FIELDS["vocab_size"], (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[0, 10:] = 0
    mask[2, 5:] = 0
    mask[3, 1:] = 0                       # [CLS] only, as "" encodes
    mask[4, :] = 0
    ids[mask == 0] = 0
    return ids, mask


@pytest.fixture(scope="module")
def flax_params():
    init = jconv.BertEncoder(JCFG).init(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 8), jnp.int32),
                                        jnp.ones((1, 8), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, flax.linen.meta.unbox(init))


@pytest.fixture(scope="module")
def hf_model():
    hf_cfg = transformers.BertConfig(
        vocab_size=FIELDS["vocab_size"], hidden_size=FIELDS["dim"],
        num_hidden_layers=FIELDS["depth"], num_attention_heads=FIELDS["heads"],
        intermediate_size=FIELDS["mlp_hidden"],
        max_position_embeddings=FIELDS["max_len"],
        type_vocab_size=FIELDS["type_vocab_size"], hidden_act="gelu",
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        layer_norm_eps=1e-12)
    torch.manual_seed(0)
    return transformers.BertModel(hf_cfg, add_pooling_layer=False).eval()


def _port(state, dtype=torch.float32):
    m = tconv.BertEncoder(TCFG, dtype)
    m.load_state_dict(state, strict=True)
    return m.eval()


def _jax_embed(params, ids, mask, dtype=jnp.float32):
    return np.asarray(jconv.BertEncoder(JCFG, dtype).apply(
        {"params": params}, jnp.asarray(ids), jnp.asarray(mask)))


def _hf_embed(m, ids, mask):
    """sentence-transformers semantics: masked mean pool + L2 norm."""
    with torch.no_grad():
        out = m(input_ids=torch.tensor(ids).long(),
                attention_mask=torch.tensor(mask)).last_hidden_state
        mk = torch.tensor(mask, dtype=torch.float32)[..., None]
        pooled = (out * mk).sum(1) / mk.sum(1).clamp(min=1e-9)
        return torch.nn.functional.normalize(pooled, dim=-1).numpy()


def test_bert_matches_flax_f32(flax_params):
    ids, mask = _inputs()
    te = tenc.encode(_port(tconv.bert_state_from_flax(flax_params)), ids, mask)
    assert te.dtype == torch.float32 and not te.requires_grad
    je = _jax_embed(flax_params, ids, mask)
    np.testing.assert_allclose(te.numpy(), je, atol=1e-5, rtol=0)
    norms = np.linalg.norm(je, axis=1)
    np.testing.assert_allclose(norms[mask.sum(1) > 0], 1.0, rtol=1e-5)
    assert norms[4] == 0.0                # no valid token: a zero embedding


def test_bert_matches_flax_bf16(flax_params):
    ids, mask = _inputs(seed=1)
    te = tenc.encode(_port(tconv.bert_state_from_flax(flax_params),
                           torch.bfloat16), ids, mask).numpy()
    je = _jax_embed(flax_params, ids, mask, jnp.bfloat16)
    rows = mask.sum(1) > 0
    assert (te[rows] * je[rows]).sum(axis=1).min() >= 0.999
    assert not te[~rows].any() and not je[~rows].any()


@pytest.mark.parametrize("prefix", PREFIXES)
def test_convert_hf_bert_matches_hf(hf_model, prefix):
    ids, mask = _inputs(seed=2)
    mask[4, :3] = 1                       # HF rows need a valid token
    sd = {prefix + k: v for k, v in hf_model.state_dict().items()}
    te = tenc.encode(_port(tconv.convert_hf_bert(sd, TCFG)), ids, mask)
    np.testing.assert_allclose(te.numpy(), _hf_embed(hf_model, ids, mask),
                               atol=1e-5, rtol=0)


def test_convert_hf_bert_same_as_jax_package(hf_model):
    ids, mask = _inputs(seed=3)
    sd = hf_model.state_dict()
    te = tenc.encode(_port(tconv.convert_hf_bert(sd, TCFG)), ids, mask)
    je = _jax_embed(jconv.convert_hf_bert(sd, JCFG), ids, mask)
    np.testing.assert_allclose(te.numpy(), je, atol=1e-5, rtol=0)


def test_minilm_config_matches_jax_package():
    assert dataclasses.asdict(tconv.minilm_l12_config()) == \
        dataclasses.asdict(jconv.minilm_l12_config())
    assert dataclasses.asdict(tconv.BertConfig()) == \
        dataclasses.asdict(jconv.BertConfig())


def test_sequence_longer_than_positions_raises(flax_params):
    m = _port(tconv.bert_state_from_flax(flax_params))
    ids = np.zeros((1, FIELDS["max_len"] + 1), np.int32)
    with pytest.raises(ValueError, match="position table"):
        tenc.encode(m, ids, np.ones_like(ids))


@pytest.mark.parametrize("fmt", ["pytorch_model.bin", "model.safetensors"])
def test_load_sentence_transformer(hf_model, tmp_path, fmt):
    sd = {f"0.auto_model.{k}": v.contiguous()
          for k, v in hf_model.state_dict().items()}
    if fmt == "model.safetensors":
        st = pytest.importorskip("safetensors.torch")
        st.save_file(sd, str(tmp_path / fmt))
    else:
        torch.save(sd, tmp_path / fmt)
    ids, mask = _inputs(seed=4)
    mask[4, :2] = 1
    tm = tconv.load_sentence_transformer(str(tmp_path), TCFG, device="cpu")
    jm, jp = jconv.load_sentence_transformer(str(tmp_path), JCFG)
    je = np.asarray(jm.apply({"params": jp}, jnp.asarray(ids),
                             jnp.asarray(mask)))
    np.testing.assert_allclose(tenc.encode(tm, ids, mask).numpy(), je,
                               atol=1e-5, rtol=0)


def test_read_safetensors_matches_the_package(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    g = torch.Generator().manual_seed(0)
    want = {"f32": torch.randn(3, 5, generator=g),
            "bf16": torch.randn(7, generator=g).to(torch.bfloat16),
            "f16": torch.randn(2, 2, generator=g).half(),
            "i64": torch.arange(-4, 5),
            "u8": torch.arange(11, dtype=torch.uint8),
            "empty": torch.zeros(0, 4)}
    path = str(tmp_path / "t.safetensors")
    st.save_file(want, path, metadata={"format": "pt"})
    got = tconv.read_safetensors(path)
    ref = st.load_file(path)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape
        assert torch.equal(got[k], ref[k]), k


def test_init_bert_encoder_seeded_and_device_rule(monkeypatch):
    a = tconv.init_bert_encoder(TCFG, seed=1, device="cpu").state_dict()
    b = tconv.init_bert_encoder(TCFG, seed=1, device="cpu").state_dict()
    c = tconv.init_bert_encoder(TCFG, seed=2, device="cpu").state_dict()
    assert set(a) == set(tconv._state_keys(TCFG))
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = "embeddings.word_embeddings.weight"
    assert not torch.equal(a[w], c[w])
    assert torch.equal(a["encoder.layer.1.output.LayerNorm.weight"],
                       torch.ones(FIELDS["dim"]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tconv.init_bert_encoder(TCFG)


def test_dense_model_with_bert_matches_jax_package(hf_model):
    """``DenseModel`` serves a ``BertEncoder`` as ``tdr``'s serves its flax
    one (tests/test_convert.py:115-147): same query embeddings, same
    lists but for near-ties."""
    sd = hf_model.state_dict()
    dcfg = dict(vocab_size=FIELDS["vocab_size"], dim=FIELDS["dim"],
                max_len=FIELDS["max_len"])
    docids = [f"d{i}" for i in range(len(DOCS))]
    j = jdense.DenseModel.build(jconv.BertEncoder(JCFG),
                                jconv.convert_hf_bert(sd, JCFG),
                                JDenseConfig(**dcfg), DOCS, docids, batch=32)
    t = tdense.DenseModel.build(_port(tconv.convert_hf_bert(sd, TCFG)),
                                DenseConfig(**dcfg), DOCS, docids, batch=32)
    queries = ["glaciers meltwater", "qubits superposition",
               "reverse osmosis membranes", "coral bleaching seawater", ""]
    jq = np.asarray(j.encode_queries(queries))
    np.testing.assert_allclose(t.encode_queries(queries).numpy(), jq,
                               atol=1e-5, rtol=0)
    jv, _ = map(np.asarray, jdense.flat_search(j.flat, jnp.asarray(jq), 8))
    jres, tres = j.retrieve(queries, k=8), t.retrieve(queries, k=8)
    for i, (a, b) in enumerate(zip(tres, jres)):
        assert len(a) == len(b) == 8
        for r, (x, y) in enumerate(zip(a, b)):
            if x != y:
                near = np.isclose(jv[i], jv[i, r], rtol=1e-5, atol=1e-5)
                assert near.sum() >= 2, f"query {i} rank {r}"
    assert tres[0][0] == "d0" and tres[1][0] == "d2"


def test_new_modules_import_without_jax_or_tdr():
    """The new modules load with jax, flax, tdr, transformers and
    safetensors blocked (the card's machine has the last two neither)."""
    code = (
        "import sys\n"
        "class B:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'flax', 'tdr',\n"
        "                                  'transformers', 'safetensors'):\n"
        "            raise ImportError('blocked ' + name)\n"
        "sys.meta_path.insert(0, B())\n"
        "import tdr_torch.models.convert, tdr_torch.rank.sentence\n"
        "from tdr_torch.models import BertEncoder, load_sentence_transformer\n"
        "from tdr_torch.rank import SentenceBM25, SentenceLmCascade\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
