"""The port's index build and host layer against the JAX package, on CPU.

Same inputs (made with numpy from a seed) go through ``tdr`` and
``tdr_torch``; integer arrays and idf must be equal, ``postings_w`` within
rtol 1e-6 (the per-entry formula may round once differently under another
op order), bf16 heads within one bf16 ulp.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from tests.torch_threads import torch

from tdr.ckpt.registry import _to_numpy_savable  # noqa: E402
from tdr.index import build as jbuild  # noqa: E402
from tdr.text import build_vocab, encode_docs  # noqa: E402
from tdr.utils.config import BM25Config, IndexConfig  # noqa: E402
from tdr_torch.index import build as tbuild  # noqa: E402
from tdr_torch.utils import config as tconfig  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _coo(seed, n_docs=300, vocab_n=700):
    rng = np.random.RandomState(seed)
    docs = [[f"t{int(rng.zipf(1.3)) % vocab_n}"
             for _ in range(rng.randint(3, 90))] for _ in range(n_docs)]
    vocab = build_vocab(docs)
    return vocab, encode_docs(docs, vocab)


def _tcfg(cfg: IndexConfig):
    return tconfig.IndexConfig(**{f: getattr(cfg, f)
                                  for f in cfg.__dataclass_fields__})


def _tbm25(b: BM25Config):
    return tconfig.BM25Config(**{f: getattr(b, f) for f in b.__dataclass_fields__})


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    return _to_numpy_savable(x)[0]


def _both(vocab, coo, cfg, use_df_host=True, weight_kind="bm25",
          bm25=BM25Config(), **kw):
    df = vocab.df if use_df_host else None
    j = jbuild.build_index(*coo, vocab.size, bm25=bm25, index_cfg=cfg,
                           weight_kind=weight_kind, df_host=df, **kw)
    t = tbuild.build_index(*coo, vocab.size, bm25=_tbm25(bm25),
                           index_cfg=_tcfg(cfg), weight_kind=weight_kind,
                           df_host=df, device="cpu", **kw)
    return j, t


def _assert_same_index(j, t, head_ulps=0, idf_exact=True):
    for f in ("n_docs", "n_docs_pad", "vocab_size", "tail_pmax", "head_size"):
        assert getattr(j, f) == getattr(t, f), f
    for f in ("indptr", "postings_doc", "postings_tf", "head_slot"):
        np.testing.assert_array_equal(_np(getattr(t, f)), _np(getattr(j, f)))
    np.testing.assert_array_equal(_np(t.stats.df), _np(j.stats.df))
    np.testing.assert_array_equal(_np(t.stats.doc_len), _np(j.stats.doc_len))
    np.testing.assert_array_equal(_np(t.stats.avgdl), _np(j.stats.avgdl))
    if idf_exact:
        np.testing.assert_array_equal(_np(t.stats.idf), _np(j.stats.idf))
    else:
        np.testing.assert_allclose(_np(t.stats.idf), _np(j.stats.idf), rtol=1e-6)
    np.testing.assert_allclose(_np(t.postings_w), _np(j.postings_w),
                               rtol=1e-6, atol=0)
    hj, ht = _np(j.head_rows), _np(t.head_rows)
    assert hj.shape == ht.shape and hj.dtype == ht.dtype
    if hj.dtype == np.uint16:
        # bf16 bit patterns of non-negative weights: one ulp = one step
        diff = np.abs(ht.astype(np.int32) - hj.astype(np.int32))
        assert diff.max() <= max(head_ulps, 1)
    else:
        np.testing.assert_allclose(ht, hj, rtol=1e-6, atol=0)


@pytest.mark.parametrize("head_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("head_size", [None, 24, 0])
def test_build_matches_jax(head_dtype, head_size):
    vocab, coo = _coo(1)
    cfg = IndexConfig(head_budget_bytes=1 << 16, head_dtype=head_dtype,
                      nnz_pad_multiple=256)
    j, t = _both(vocab, coo, cfg, head_size=head_size)
    _assert_same_index(j, t)


@pytest.mark.parametrize("case", ["no_bucketing", "no_df_host", "tfidf",
                                  "scaled_b"])
def test_build_variants_match_jax(case):
    vocab, coo = _coo(2)
    cfg = IndexConfig(head_budget_bytes=1 << 15, head_dtype="float32")
    kw = {}
    if case == "no_bucketing":
        cfg = IndexConfig(head_budget_bytes=1 << 15, head_dtype="float32",
                          shape_bucketing=False, doc_pad_multiple=8,
                          nnz_pad_multiple=64)
    elif case == "no_df_host":
        kw["use_df_host"] = False
    elif case == "tfidf":
        kw.update(weight_kind="tfidf", bm25=BM25Config(idf_variant="classic"))
    else:
        kw["bm25"] = BM25Config(k1=1.2, b=0.6, dl_scaled_by_b=True)
    j, t = _both(vocab, coo, cfg, **kw)
    # without df_host the JAX build takes idf from jnp.log1p on its device;
    # the port always uses the host formula: an ulp apart at most
    _assert_same_index(j, t, idf_exact=(case != "no_df_host"))


def test_int8_head_matches_jax():
    vocab, coo = _coo(3)
    cfg = IndexConfig(head_budget_bytes=1 << 16, head_dtype="int8")
    j, t = _both(vocab, coo, cfg)
    np.testing.assert_allclose(_np(t.head_scale), _np(j.head_scale), rtol=1e-6)
    # q8 = round(w / scale): a weight one ulp apart may round the other way
    diff = np.abs(_np(t.head_rows).astype(np.int32)
                  - _np(j.head_rows).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    q = tbuild.quantize_head(tbuild.build_index(
        *coo, vocab.size, index_cfg=_tcfg(IndexConfig(head_dtype="float32")),
        head_size=t.head_size, df_host=vocab.df, device="cpu"))
    assert q.head_rows.dtype == torch.int8
    np.testing.assert_array_equal(q.head_rows.numpy(), t.head_rows.numpy())


@pytest.mark.parametrize("n", [1, 7, 128, 129, 1000, 4097, 65536, 207363,
                               490667])
def test_static_shape_rules_match_jax(n):
    assert tbuild._bucket(n) == jbuild._bucket(n)
    assert tbuild._bucket(n, 8) == jbuild._bucket(n, 8)
    for cfg in (IndexConfig(), IndexConfig(shape_bucketing=False),
                IndexConfig(head_dtype="float32", head_budget_bytes=1 << 20)):
        tc = _tcfg(cfg)
        assert tbuild._pad_docs(n, tc) == jbuild._pad_docs(n, cfg)
        assert tbuild.full_head_bytes(n, 3 * n, tc) == \
            jbuild.full_head_bytes(n, 3 * n, cfg)
        pad = jbuild._pad_docs(n, cfg)
        assert tbuild._auto_head_size(n, pad, tc) == \
            jbuild._auto_head_size(n, pad, cfg)


def test_index_carried_across_from_jax():
    """sparse_index_from_arrays takes a JAX-built index in checkpoint
    layout (bf16 as uint16 bits) and holds the same arrays bit for bit."""
    vocab, coo = _coo(4)
    j = jbuild.build_index(*coo, vocab.size, df_host=vocab.df,
                           index_cfg=IndexConfig(head_budget_bytes=1 << 16))
    arrays, dtypes = {}, {}
    for name in ("indptr", "postings_doc", "postings_w", "postings_tf",
                 "head_slot", "head_rows"):
        arrays[name], dtypes[name] = _to_numpy_savable(getattr(j, name))
    for name in ("df", "idf", "doc_len", "avgdl"):
        arrays[f"stats_{name}"], dtypes[f"stats_{name}"] = \
            _to_numpy_savable(getattr(j.stats, name))
    meta = {"statics": {k: getattr(j, k) for k in (
        "n_docs", "n_docs_pad", "vocab_size", "tail_pmax", "head_size")},
        "dtypes": dtypes}
    t = tbuild.sparse_index_from_arrays(arrays, meta, device="cpu")
    assert t.head_rows.dtype == torch.bfloat16
    _assert_same_index(j, t)
    np.testing.assert_array_equal(_np(t.head_rows), arrays["head_rows"])
    moved = t.to("cpu")
    assert moved.device == t.device and moved.stats.idf.device == t.device


def test_device_rule(monkeypatch):
    from tdr_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    vocab, coo = _coo(5, n_docs=20)
    with pytest.raises(RuntimeError):
        tbuild.build_index(*coo, vocab.size)
    assert resolve_device("cpu").type == "cpu"


# -- host layer ---------------------------------------------------------------

def _native_built_once():
    """Build the port's native tokenizer under a file lock: test workers
    must not run its lazy `make` at the same time."""
    import fcntl
    import tempfile

    path = os.path.join(tempfile.gettempdir(), "tdr_torch_native.lock")
    with open(path, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        from tdr_torch import native

        assert native.available()


_REAL_WORDS = {
    "fr": "continuellement nationalité connaissances générations chevaux "
          "impératrice heureusement mangeaient finissions précipitamment "
          "aimable jouissance ouvrières".split(),
    "de": "häuser aufeinanderfolgenden gesellschaften möglichkeiten "
          "kinder verantwortlich größte fußballspieler zusammenarbeit "
          "ärgerlich übersetzungen".split(),
    "es": "corriendo nacionalidades conocimientos generaciones caballos "
          "rápidamente comeríamos información niños acciones "
          "desafortunadamente".split(),
    "it": "abbandonata nazionalità conoscenze generazioni cavalli "
          "rapidamente mangeremmo informazione bambini perché "
          "sfortunatamente".split(),
}


@pytest.mark.parametrize("lang", ["fr", "de", "es", "it"])
def test_snowball_copy_matches_nltk(lang):
    from nltk.stem.snowball import SnowballStemmer

    from tdr.data.synthetic import _make_word
    from tdr_torch.text.lemmatize import normalizer_for

    rng = np.random.RandomState(11)
    words = [_make_word(rng, lang) for _ in range(1500)] + _REAL_WORDS[lang]
    words += [w + s for w in words[:200] for s in ("s", "ement", "ungen", "ità")]
    ref = SnowballStemmer({"fr": "french", "de": "german", "es": "spanish",
                           "it": "italian"}[lang])
    ours = normalizer_for(lang)
    assert [ours(w) for w in words] == [ref.stem(w) for w in words]


_PORTER_EN = ("caresses ponies ties caress cats feed agreed plastered bled "
              "motoring sing conflated troubled sized hopping tanned falling "
              "hissing fizzed failing filing happy sky relational "
              "conditional rational valenci hesitanci digitizer conformabli "
              "radicalli differentli vileli analogousli vietnamization "
              "predication operator feudalism decisiveness hopefulness "
              "callousness formaliti sensitiviti sensibiliti triplicate "
              "formative formalize electriciti electrical hopeful goodness "
              "revival allowance inference airliner gyroscopic adjustable "
              "defensible irritant replacement adjustment dependent adoption "
              "homologou communism activate angulariti homologous effective "
              "bowdlerize probate rate cease controll roll generalizations "
              "oscillators dying lying tying skies news innings outing "
              "canning howe proceed exceed succeed generously").split()


def _porter_words(lang):
    """2,000 generated words of ``lang``, the real-text set's words of
    ``lang`` and, for en, the Porter paper's examples, each also with a few
    suffixes that reach the algorithm's steps."""
    import re

    from tdr.data.realtext import REAL_DOCS, REAL_QUERIES
    from tdr.data.synthetic import _make_word

    rng = np.random.RandomState(13)
    words = [_make_word(rng, lang) for _ in range(2000)]
    text = " ".join([t for _, t in REAL_DOCS[lang]]
                    + [q for q, _ in REAL_QUERIES[lang]])
    words += sorted(set(re.findall(r"\w+", text)))
    if lang == "en":
        words += _PORTER_EN
    words += [w + s for w in words[:300] for s in
              ("s", "ies", "ational", "ness", "ing", "ed", "ly", "ement")]
    words += ["", "a", "Ab", "BY", "ies", "sses", "y", "yy", "eed", "ing"]
    return words


@pytest.mark.parametrize("lang", ["en", "fr", "de", "es", "it", "ar", "ko"])
def test_porter_normalizer_matches_jax_package(lang):
    """The vendored Porter stemmer (NLTK_EXTENSIONS, lower-casing) equals
    ``tdr``'s nltk ``PorterStemmer`` on every word."""
    from tdr.text.lemmatize import normalizer_for as j_norm
    from tdr_torch.text.lemmatize import normalizer_for as t_norm

    words = _porter_words(lang)
    assert len(words) >= 2000
    ours, ref = t_norm(lang, "porter"), j_norm(lang, "porter")
    assert [ours(w) for w in words] == [ref(w) for w in words]


@pytest.mark.parametrize("source", ["synthetic", "realtext"])
def test_porter_pipeline_matches_jax_package(source):
    """``preprocess_texts(..., pipeline="porter")`` gives ``tdr``'s token
    lists on a synthetic corpus of the seven languages and on the real-text
    set (documents and queries)."""
    from tdr.text import preprocess_texts as j_pre
    from tdr_torch.text import preprocess_texts as t_pre

    if source == "synthetic":
        from tdr.data import SyntheticSpec, synthetic_corpus

        corpus, queries = synthetic_corpus(SyntheticSpec(
            n_docs=400, n_queries=80, seed=5))
        texts = list(corpus.texts) + list(queries.queries)
        langs = list(corpus.langs) + list(queries.langs)
    else:
        from tdr.data.realtext import real_eval_corpus

        docs, _, dlangs, qs, qlangs, _ = real_eval_corpus()
        texts, langs = docs + qs, dlangs + qlangs
    ours = t_pre(texts, langs, pipeline="porter")
    assert ours == j_pre(texts, langs, pipeline="porter")
    assert ours != t_pre(texts, langs, pipeline="best")


@pytest.mark.parametrize("lang", ["en", "de", "ko"])
def test_fast_encode_copy_matches_jax_package(lang):
    from tdr.data import SyntheticSpec, synthetic_corpus
    from tdr.text.fast import fast_encode_corpus as j_enc
    from tdr_torch.text.fast import fast_encode_corpus as t_enc

    _native_built_once()

    corpus, _ = synthetic_corpus(SyntheticSpec(n_docs=400, n_queries=4,
                                               seed=5, hard=True))
    texts = [t for t, l in zip(corpus.texts, corpus.langs) if l == lang]
    jv, *jc = j_enc(texts, [lang] * len(texts))
    tv, *tc = t_enc(texts, [lang] * len(texts))
    assert jv.term_to_id == tv.term_to_id and jv.pair_to_id == tv.pair_to_id
    for a, b in zip(jc, tc):
        np.testing.assert_array_equal(a, b)


def test_port_imports_no_jax_nltk_or_tdr():
    """Every module of tdr_torch, and chip_smoke.py, parallel_check.py and
    tree_compare.py, import with jax, nltk and tdr blocked."""
    code = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "class B:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'nltk', 'tdr'):\n"
        "            raise ImportError('blocked ' + name)\n"
        "sys.meta_path.insert(0, B())\n"
        "import tdr_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    tdr_torch.__path__, 'tdr_torch.')\n"
        "    if importlib.util.find_spec(m.name).origin.endswith('.py')]\n"
        "names += ['chip_smoke', 'parallel_check', 'tree_compare']\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_files = sum(f.endswith(".py") for _, _, fs in
                  os.walk(os.path.join(REPO, "tdr_torch")) for f in fs)
    # every file but the root __init__.py, which is the package itself
    assert int(out.stdout.strip()) == n_files - 1 + 3
