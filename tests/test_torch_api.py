"""The port's public surface against ``tdr``'s, on CPU.

A ``tdr`` program should move to ``tdr_torch`` by changing its imports:

* every name in each ``tdr`` subpackage's ``__all__``, and ``tdr.LANGS``,
  exists in the port;
* for every public function, class (its constructor) and method of every
  ``tdr`` module, the port's counterpart takes ``tdr``'s parameters as a
  prefix of its own, in ``tdr``'s order, with ``tdr``'s defaults; a
  parameter only the port has comes after them or is keyword-only, and
  has a default.  ``tdr``'s Pallas modules map name by name to the port's
  kernel modules (``KERNEL_NAMES``);
* the differences that come from JAX's functional style are the entries of
  ``EXCUSED``, each with its reason, and nothing else is excused; an entry
  whose item no longer differs fails as stale.

Then the helpers this surface added are held to ``tdr`` on seeded inputs,
the calls that once bound to the wrong parameter are made positionally in
both packages, and the engine keywords that change nothing in the port
(``tail_engine``, ``cand_engine``, ``rank_engine``, ``recall_target``,
``sub``, ``interpret``) give the default call's results.
"""

import dataclasses
import importlib
import importlib.util
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest

from tests.torch_threads import torch

import jax.numpy as jnp  # noqa: E402

import tdr  # noqa: E402
import tdr_torch  # noqa: E402
from tdr.index import build as jbuild  # noqa: E402
from tdr.text import build_vocab, encode_docs, encode_queries  # noqa: E402
from tdr.utils.config import BM25Config, IndexConfig  # noqa: E402
from tdr_torch.index import build as tbuild  # noqa: E402
from tdr_torch.utils import config as tconfig  # noqa: E402
from test_torch_kernels import assert_same_topk, carry  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tdr's Pallas modules have no module of the same name in the port: each
# public name maps to its kernel module's wrapper
KERNEL_NAMES = {
    "tdr.ops.pallas_tail.tail_compact_pallas":
        "tdr_torch.ops.tail_compact.tail_compact",
    "tdr.ops.pallas_tail.dma_window": "tdr_torch.ops.tail_compact.dma_window",
    "tdr.ops.pallas_flat.fused_flat_available":
        "tdr_torch.ops.fused_flat.fused_flat_available",
    "tdr.ops.pallas_flat.fused_flat_topk":
        "tdr_torch.ops.fused_flat.fused_flat_topk",
    "tdr.ops.pallas_flat.fused_head_available":
        "tdr_torch.ops.fused_head.fused_head_available",
    "tdr.ops.pallas_flat.fused_head_topk":
        "tdr_torch.ops.fused_head.fused_head_topk",
    "tdr.ops.pallas_score.head_scores_pallas":
        "tdr_torch.ops.head_scores.head_scores",
    "tdr.ops.pallas_score.pallas_head_available":
        "tdr_torch.ops.head_scores.head_scores_available",
}
_KERNEL_MODULES = ("tdr.ops.pallas_tail", "tdr.ops.pallas_flat",
                   "tdr.ops.pallas_score")

_FLAX = "flax module fields (parent, name, dtype/heads as module config)"
EXCUSED = {
    "tdr.utils.jax_cache": "XLA's compile cache; the port caches its kernels' "
                           ".so (ops/cuda_build.py)",
    "tdr.ops.pallas_tail.pallas_tail_available":
        "no engine to gate: K1 serves every tail on the card",
    "tdr.models.encoder.encode": "flax params passed beside the module",
    "tdr.models.dense.DenseModel": "flax params field beside the module",
    "tdr.models.dense.DenseModel.build": "flax params passed beside the module",
    "tdr.ops.svd.tfidf_svd": "a JAX PRNG key; the port takes a start matrix "
                             "or a seed",
    "tdr.train.contrastive.TrainState": "optax params/opt_state; the port "
                                        "holds a module and an optimizer",
    "tdr.train.contrastive.make_train_step": "optax tx and a flax module",
    "tdr.train.contrastive.param_shardings": "a flax params pytree; the port "
                                             "shards a module",
    "tdr.parallel.mesh.data_sharding": "NamedSharding builder; the port "
                                       "places a tensor",
    "tdr.parallel.mesh.replicated": "NamedSharding builder; the port places "
                                    "a tensor",
    "tdr.models.convert.BertEncoder": _FLAX,
    "tdr.models.encoder.MlpBlock": _FLAX,
    "tdr.models.encoder.EncoderBlock": _FLAX,
    "tdr.models.encoder.DualEncoder": _FLAX,
    "tdr.parallel.sharded.ShardedSparseIndex": "stacked (S, ...) arrays; the "
                                               "port keeps one index per shard",
}

_POS = (inspect.Parameter.POSITIONAL_ONLY,
        inspect.Parameter.POSITIONAL_OR_KEYWORD)
_VAR = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)


def _tdr_modules():
    """Every ``tdr`` module, found on disk (collection imports nothing)."""
    out = []
    for root, _, files in os.walk(os.path.join(REPO, "tdr")):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                name = rel.replace(os.sep, ".")
                out.append(name[:-len(".__init__")]
                           if name.endswith(".__init__") else name)
    return sorted(out)


def _port_name(qualname: str) -> str:
    return KERNEL_NAMES.get(qualname, "tdr_torch" + qualname[len("tdr"):])


def _resolve(qualname: str):
    """Import ``a.b.c.Name[.attr]``: the longest importable module prefix,
    then attributes."""
    parts = qualname.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
        except ImportError:
            continue
        for p in parts[i:]:
            obj = getattr(obj, p)
        return obj
    raise ImportError(qualname)


def _norm_default(x):
    if isinstance(x, type):
        return x.__name__
    if isinstance(x, torch.dtype):
        return str(x).replace("torch.", "")
    if dataclasses.is_dataclass(x):
        return repr(x)
    return x


def _same_default(a, b) -> bool:
    if a is inspect.Parameter.empty or b is inspect.Parameter.empty:
        return a is b
    try:
        return bool(_norm_default(a) == _norm_default(b))
    except (TypeError, ValueError):
        return False


def signature_gap(a, b):
    """Why the port's callable ``b`` cannot take every call ``tdr``'s ``a``
    takes, or None."""
    sigs = []
    for f in (a, b):
        try:
            sigs.append(list(inspect.signature(f).parameters.values()))
        except (TypeError, ValueError):      # e.g. a builtin exception type
            sigs.append(None)
    pa, pb = sigs
    if pa is None or pb is None:
        return None if pa is pb else "one side has no signature"
    a_pos = [p.name for p in pa if p.kind in _POS]
    b_pos = [p.name for p in pb if p.kind in _POS]
    if b_pos[:len(a_pos)] != a_pos:
        return f"positional {a_pos} is not a prefix of {b_pos}"
    bmap = {p.name: p for p in pb}
    for p in pa:
        if p.kind in _VAR:
            if not any(q.kind == p.kind for q in pb):
                return f"no {p.kind.description} parameter"
            if p.kind == inspect.Parameter.VAR_POSITIONAL and b_pos != a_pos:
                return f"port-only positional parameters before *{p.name}"
            continue
        q = bmap.get(p.name)
        if q is None:
            return f"parameter {p.name!r} missing"
        if q.kind not in _POS + (inspect.Parameter.KEYWORD_ONLY,):
            return f"parameter {p.name!r} is {q.kind.description}"
        if not _same_default(p.default, q.default):
            return (f"parameter {p.name!r}: default {q.default!r}, tdr's is "
                    f"{p.default!r}")
    names = {p.name for p in pa}
    for q in pb:
        if (q.name not in names and q.kind not in _VAR
                and q.default is inspect.Parameter.empty):
            return f"port-only parameter {q.name!r} has no default"
    return None


def _public_items(mod):
    """(qualname, tdr object, kind) for the module's own public functions,
    classes and their methods and properties."""
    for name, obj in sorted(vars(mod).items()):
        if name.startswith("_") or getattr(obj, "__module__", None) != mod.__name__:
            continue
        qual = f"{mod.__name__}.{name}"
        if inspect.isclass(obj):
            yield qual, obj, "callable"
            for mname, raw in sorted(vars(obj).items()):
                if mname.startswith("_"):
                    continue
                if isinstance(raw, property):
                    yield f"{qual}.{mname}", raw, "property"
                elif inspect.isfunction(inspect.unwrap(
                        getattr(raw, "__func__", raw))):
                    yield f"{qual}.{mname}", getattr(obj, mname), "callable"
        elif callable(obj) and inspect.isfunction(inspect.unwrap(obj)):
            yield qual, obj, "callable"


def item_gap(qual, obj, kind):
    port = _port_name(qual)
    try:
        other = _resolve(port)
    except (ImportError, AttributeError):
        return f"{port} missing"
    if kind == "property":
        owner, attr = port.rsplit(".", 1)
        if not isinstance(inspect.getattr_static(_resolve(owner), attr),
                          property):
            return f"{port} is not a property"
        return None
    return signature_gap(obj, other)


@pytest.mark.parametrize("modname", _tdr_modules())
def test_signatures_are_a_prefix_of_the_port(modname):
    if modname in EXCUSED:
        spec = importlib.util.find_spec("tdr_torch" + modname[len("tdr"):])
        assert spec is None, f"{modname} is excused but has a counterpart"
        return
    mod = importlib.import_module(modname)
    if modname not in _KERNEL_MODULES:
        importlib.import_module("tdr_torch" + modname[len("tdr"):])
    gaps, stale = [], []
    for qual, obj, kind in _public_items(mod):
        gap = item_gap(qual, obj, kind)
        if qual in EXCUSED:
            if gap is None:
                stale.append(qual)
        elif gap is not None:
            gaps.append(f"{qual}: {gap}")
    assert not gaps, "\n".join(gaps)
    assert not stale, f"excused but no longer different: {stale}"


def test_kernel_table_and_exceptions_name_real_items():
    for modname in _KERNEL_MODULES:
        mod = importlib.import_module(modname)
        names = {q for q, _, _ in _public_items(mod)}
        assert names == {q for q in list(KERNEL_NAMES) + list(EXCUSED)
                         if q.startswith(modname + ".")}
    for qual, reason in EXCUSED.items():
        assert reason and _resolve(qual) is not None, qual


def _subpackages():
    return sorted(m for m in _tdr_modules()
                  if os.path.exists(os.path.join(REPO, *m.split("."),
                                                 "__init__.py")))


@pytest.mark.parametrize("pkg", _subpackages())
def test_all_names_exist_in_the_port(pkg):
    mod = importlib.import_module(pkg)
    port = importlib.import_module("tdr_torch" + pkg[len("tdr"):])
    missing = [n for n in getattr(mod, "__all__", []) if not hasattr(port, n)]
    assert not missing, f"{pkg}: {missing}"
    missing_all = [n for n in getattr(mod, "__all__", [])
                   if n not in getattr(port, "__all__", [])]
    assert not missing_all, f"{pkg}.__all__ lacks {missing_all}"


def test_langs():
    assert tdr_torch.LANGS == tdr.LANGS
    assert tdr_torch.LANGS is tconfig.LANGS


def test_import_ops_builds_no_kernel():
    code = ("import tdr_torch.ops as ops\n"
            "from tdr_torch.ops import cuda_build, score_pairs\n"
            "assert cuda_build._lib is None, 'library loaded'\n"
            "assert cuda_build.build_seconds is None, 'library built'\n"
            "assert not any(cuda_build.launches.values())\n"
            "print(sorted(ops.__all__))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    import tdr.ops

    assert out.stdout.strip() == str(sorted(tdr.ops.__all__))


# ---- the helpers, held to tdr ----------------------------------------------

def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def _coo(seed=0, n_docs=300, vocab_n=700):
    rng = np.random.RandomState(seed)
    docs = [[f"t{int(rng.zipf(1.3)) % vocab_n}"
             for _ in range(rng.randint(3, 90))] for _ in range(n_docs)]
    vocab = build_vocab(docs)
    return vocab, encode_docs(docs, vocab), docs


def _tcfg(cfg):
    return tconfig.IndexConfig(**dataclasses.asdict(cfg))


def _tbm25(b):
    return tconfig.BM25Config(**dataclasses.asdict(b))


@pytest.mark.parametrize("variant", ["bm25", "bm25_plus1", "classic"])
def test_compute_idf_matches_jax(variant):
    vocab, coo, _ = _coo(1)
    n_docs = int(coo[3].shape[0])
    df = np.zeros(vocab.size + 13, np.float32)
    df[:vocab.size] = vocab.df
    j = np.asarray(jbuild.compute_idf(jnp.asarray(df), n_docs, variant))
    t_arr = tbuild.compute_idf(df, n_docs, variant, device="cpu")
    t_ten = tbuild.compute_idf(torch.from_numpy(df), n_docs, variant)
    assert t_arr.dtype == torch.float32 and t_arr.device.type == "cpu"
    assert torch.equal(t_arr, t_ten)
    # tests/test_torch_build.py's host-idf bound; numpy's float32 log1p and
    # XLA's round differently, up to 3 ulps apart on the x86 CPUs measured
    np.testing.assert_allclose(t_arr.numpy(), j, rtol=1e-6)
    assert _ulps(t_arr.numpy(), j).max() <= 3
    # the index's idf IS compute_idf of the build's df, bit for bit
    bm25 = BM25Config(idf_variant=variant)
    cfg = IndexConfig(head_budget_bytes=1 << 16, nnz_pad_multiple=256)
    for df_host in (vocab.df, None):
        t = tbuild.build_index(*coo, vocab.size, bm25=_tbm25(bm25),
                               index_cfg=_tcfg(cfg), df_host=df_host,
                               device="cpu")
        again = tbuild.compute_idf(t.stats.df, n_docs, variant)
        assert torch.equal(again, t.stats.idf)
    with pytest.raises(ValueError, match="unknown idf variant"):
        tbuild.compute_idf(df, n_docs, "bm26", device="cpu")
    with pytest.raises(ValueError, match="unknown idf variant"):
        jbuild.compute_idf(jnp.asarray(df), n_docs, "bm26")


def test_segment_df_matches_jax():
    rng = np.random.RandomState(2)
    V = 300
    ti = rng.randint(0, V, 5000).astype(np.int32)
    ti[rng.rand(5000) < 0.2] = V                     # padding ids
    j = np.asarray(jbuild.segment_df(jnp.asarray(ti), V))
    t = tbuild.segment_df(torch.from_numpy(ti), V)
    assert t.dtype == torch.float32 and t.shape == (V,)
    np.testing.assert_array_equal(t.numpy(), j)
    assert t.sum().item() == (ti < V).sum()


@pytest.mark.parametrize("head_size", [1, 40, 97, 200])
def test_select_head_matches_lax_top_k(head_size):
    """Many ties, and zero-df terms inside the top ``head_size``."""
    rng = np.random.RandomState(head_size)
    df = rng.choice([0.0, 1.0, 2.0, 3.0, 7.0], 200,
                    p=[0.4, 0.3, 0.15, 0.1, 0.05]).astype(np.float32)
    assert (df > 0).sum() < 200
    j = np.asarray(jbuild.select_head(jnp.asarray(df), head_size))
    t = tbuild.select_head(torch.from_numpy(df), head_size)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), j)
    if head_size == 200:
        assert (j == -1).sum() == (df == 0).sum()     # zero df is never kept


def test_select_head_is_the_builds():
    vocab, coo, _ = _coo(4)
    t = tbuild.build_index(*coo, vocab.size, index_cfg=_tcfg(IndexConfig(
        head_budget_bytes=1 << 15)), df_host=vocab.df, device="cpu")
    assert torch.equal(tbuild.select_head(t.stats.df, t.head_size),
                       t.head_slot)
    assert torch.equal(tbuild.segment_df(torch.from_numpy(coo[1]),
                                         t.vocab_size), t.stats.df)


@pytest.mark.parametrize("head_dtype", ["bfloat16", "float32", "int8"])
def test_nnz_and_memory_bytes_match_jax(head_dtype):
    vocab, coo, _ = _coo(3)
    cfg = IndexConfig(head_budget_bytes=1 << 16, head_dtype=head_dtype,
                      nnz_pad_multiple=256)
    j = jbuild.build_index(*coo, vocab.size, index_cfg=cfg, df_host=vocab.df)
    t = tbuild.build_index(*coo, vocab.size, index_cfg=_tcfg(cfg),
                           df_host=vocab.df, device="cpu")
    assert t.nnz == j.nnz
    assert t.memory_bytes() == j.memory_bytes()
    assert (t.head_scale is not None) == (head_dtype == "int8")


# ---- positional calls that once bound to other parameters -----------------

def test_build_index_positional_overrides():
    """``idf`` is the 10th parameter, ``head_slot`` the 11th and ``avgdl``
    the 12th, as in ``tdr``."""
    vocab, coo, _ = _coo(5)
    n = vocab.size
    cfg = IndexConfig(head_budget_bytes=1 << 15, head_dtype="float32",
                      nnz_pad_multiple=256)
    rng = np.random.RandomState(0)
    vocab_pad = jbuild._bucket(n, 128)
    idf = (1.0 + rng.rand(vocab_pad)).astype(np.float32)
    df = np.zeros(vocab_pad, np.float32)
    df[:n] = vocab.df
    head_slot = np.asarray(jbuild.select_head(jnp.asarray(df), 24))
    j = jbuild.build_index(*coo, n, BM25Config(), cfg, "bm25", 24, idf,
                           head_slot, 11.5)
    t = tbuild.build_index(*coo, n, BM25Config(), _tcfg(cfg), "bm25", 24,
                           idf, head_slot, 11.5, device="cpu")
    np.testing.assert_array_equal(t.stats.idf.numpy(), idf)
    np.testing.assert_array_equal(t.head_slot.numpy(), head_slot)
    assert float(t.stats.avgdl) == float(j.stats.avgdl) == 11.5
    for f in ("n_docs_pad", "vocab_size", "tail_pmax", "head_size"):
        assert getattr(t, f) == getattr(j, f), f
    for f in ("indptr", "postings_doc"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)))
    np.testing.assert_allclose(t.postings_w.numpy(), np.asarray(j.postings_w),
                               rtol=1e-6)
    np.testing.assert_allclose(t.head_rows.numpy(), np.asarray(j.head_rows),
                               rtol=1e-6)


def _rerank_world():
    vocab, coo, docs = _coo(6, n_docs=400)
    cfg = IndexConfig(head_budget_bytes=1 << 15, nnz_pad_multiple=64)
    jr = jbuild.build_index(*coo, vocab.size, index_cfg=cfg, head_size=16)
    rng = np.random.RandomState(2)
    queries = [list(docs[rng.randint(len(docs))][:6]) for _ in range(16)]
    qids, qw = encode_queries(queries, vocab, 16)
    cand = np.stack([rng.choice(jr.n_docs, 40, replace=False)
                     for _ in range(qids.shape[0])]).astype(np.int32)
    vals1 = rng.rand(*cand.shape).astype(np.float32)
    return jr, qids, qw, cand, vals1


def test_rerank_pairs_topk_positional_engine():
    """A positional ``tail_engine`` is the 8th parameter, not ``exact_pairs``:
    on a bf16 head the fused re-score and the exact pair scorer differ by
    the head's rounding."""
    from tdr.rank import cascade as jcas
    from tdr_torch.rank import cascade as tcas

    jr, qids, qw, cand, vals1 = _rerank_world()
    assert jr.head_rows.dtype == jnp.bfloat16
    tr = carry(jr)
    jv, jrows = jcas.rerank_pairs_topk(
        jr, jnp.asarray(qids), jnp.asarray(qw), jnp.asarray(cand),
        jnp.asarray(vals1), 10, 64, "xla")
    tv, trows = tcas.rerank_pairs_topk(
        tr, torch.from_numpy(qids), torch.from_numpy(qw),
        torch.from_numpy(cand).long(), torch.from_numpy(vals1), 10, 64, "xla")
    assert_same_topk(tv, trows, jv, jrows, rtol=1e-6, atol=1e-6)
    pv, _ = tcas.rerank_pairs_topk(
        tr, torch.from_numpy(qids), torch.from_numpy(qw),
        torch.from_numpy(cand).long(), torch.from_numpy(vals1), 10, 64,
        "xla", True)
    assert not torch.equal(pv, tv)        # exact_pairs=True does differ here


def test_bm25_model_positional_fields():
    """``tail_engine`` sits between ``use_fused_topk`` and ``topk_mode``."""
    from tdr.models.sparse import BM25Model as JBM25
    from tdr_torch.models.sparse import BM25Model as TBM25

    vocab, coo, docs = _coo(7, n_docs=300)
    cfg = IndexConfig(head_budget_bytes=1 << 15, nnz_pad_multiple=64)
    jix = jbuild.build_index(*coo, vocab.size, index_cfg=cfg, head_size=16)
    docids = [f"d{i}" for i in range(len(docs))]
    args = ("en", 32, "unit", 256, True, "xla", "exact_compact", 4)
    jm = JBM25(vocab, jix, docids, *args)
    tm = TBM25(vocab, carry(jix), docids, *args)
    assert (tm.tail_engine, tm.topk_mode, tm.small_q_threshold) == \
        ("xla", "exact_compact", 4)
    rng = np.random.RandomState(3)
    queries = [list(docs[rng.randint(len(docs))][:5]) for _ in range(12)]
    jv, jrows = jm.topk_tokens(queries, k=10)
    tv, trows = tm.topk_tokens(queries, k=10)
    assert_same_topk(tv, trows, jv, jrows, rtol=1e-6, atol=1e-6)


def test_build_language_models_positional_resume_dir(tmp_path):
    from tdr.data import SyntheticSpec, synthetic_corpus
    from tdr_torch.rank import router as trouter
    from test_torch_router import _native_built_once

    _native_built_once()
    corpus, _ = synthetic_corpus(SyntheticSpec(
        n_docs=200, n_queries=4, seed=3, langs=("en", "fr"),
        ref_proportions=False))
    cfg = tconfig.IndexConfig(head_budget_bytes=1 << 20)
    models = trouter.build_language_models(
        corpus, trouter.BM25Model, None, tconfig.BM25Config(), cfg, 64, None,
        None, True, str(tmp_path), device="cpu")
    assert sorted(models) == sorted(os.listdir(tmp_path)) == ["en", "fr"]


# ---- keywords that change nothing in the port ------------------------------

_ENGINES = ("auto", "xla", "pallas", "pallas_interpret")


def test_tail_engine_values_give_the_default_lists():
    from tdr_torch.models.sparse import BM25Model as TBM25
    from tdr_torch.ops import score as tscore
    from tdr_torch.rank import cascade as tcas

    jr, qids, qw, cand, vals1 = _rerank_world()
    t = carry(jr)
    assert t.head_size < t.vocab_size              # a tail to compact
    q, w = torch.from_numpy(qids), torch.from_numpy(qw)
    c, v1 = torch.from_numpy(cand).long(), torch.from_numpy(vals1)
    base = tscore.score_and_topk_fused(t, q, w, top_k=10, tail_budget=64)
    base_c = tscore.score_candidates_fused(t, q, w, c, tail_budget=64)
    base_r = tcas.rerank_pairs_topk(t, q, w, c, v1, 10, tail_budget=64)
    base_s = tcas.cascade_score_topk(t, t, q, w, q, w, 50, 10, 64)
    m = TBM25(None, t, [str(i) for i in range(t.n_docs)], tail_budget=64,
              small_q_threshold=0)
    base_m = m._score_encoded(q, w, 10)
    for eng in _ENGINES:
        got = tscore.score_and_topk_fused(t, q, w, top_k=10, tail_budget=64,
                                          tail_engine=eng)
        assert all(torch.equal(a, b) for a, b in zip(got, base)), eng
        assert torch.equal(tscore.score_candidates_fused(
            t, q, w, c, tail_budget=64, tail_engine=eng), base_c), eng
        got = tcas.rerank_pairs_topk(t, q, w, c, v1, 10, tail_budget=64,
                                     tail_engine=eng)
        assert all(torch.equal(a, b) for a, b in zip(got, base_r)), eng
        got = tcas.cascade_score_topk(t, t, q, w, q, w, 50, 10, 64,
                                      cand_engine=eng, rank_engine=eng)
        assert all(torch.equal(a, b) for a, b in zip(got, base_s)), eng
        got = dataclasses.replace(m, tail_engine=eng)._score_encoded(q, w, 10)
        assert all(torch.equal(a, b) for a, b in zip(got, base_m)), eng


def test_recall_target_sub_and_interpret_change_nothing():
    from tdr_torch.models import dense as tdense
    from tdr_torch.ops import fused_flat, fused_head, head_scores, tail_compact

    rng = np.random.RandomState(0)
    flat = tdense.build_flat_index(rng.randn(300, 32).astype(np.float32),
                                   device="cpu")
    q = torch.from_numpy(rng.randn(5, 32).astype(np.float32))
    for fn, kw in ((tdense.flat_search, {}),
                   (tdense.flat_search_prf, {"n_feedback": 4})):
        base = fn(flat, q, 10, **kw)
        for rt in (0.5, 0.95, 0.999):
            got = fn(flat, q, 10, recall_target=rt, **kw)
            assert all(torch.equal(a, b) for a, b in zip(got, base))
        got = fn(flat, q, 10, approx=True, recall_target=0.5, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, base))

    emb = torch.from_numpy(rng.randn(256, 128).astype(np.float32))
    args = dict(top_k=10, metric="ip", n_docs=250)
    base = fused_flat.fused_flat_topk(emb, q.repeat(1, 4), **args)
    got = fused_flat.fused_flat_topk(emb, q.repeat(1, 4), sub=8,
                                     interpret=True, **args)
    assert all(torch.equal(a, b) for a, b in zip(got, base))
    with pytest.raises(ValueError, match="groups 8"):
        fused_flat.fused_flat_topk(emb, q.repeat(1, 4), sub=16, **args)
    assert not fused_flat.fused_flat_available(emb, 10, sub=16)

    jr, qids, qw, _, _ = _rerank_world()
    t = carry(jr)
    qt, wt = torch.from_numpy(qids), torch.from_numpy(qw)
    assert torch.equal(head_scores.head_scores(t, qt, wt, 16, True),
                       head_scores.head_scores(t, qt, wt, 16))
    got = tail_compact.tail_compact(t, qt, wt, 256, 16, True)
    base = tail_compact.tail_compact(t, qt, wt, 256, 16)
    assert all(torch.equal(a, b) for a, b in zip(got, base))
    full = dataclasses.replace(t, head_size=t.vocab_size)
    assert not fused_head.fused_head_available(full, 10, sub=16)
    with pytest.raises(ValueError, match="groups 8"):
        fused_head.fused_head_topk(t, qt, wt, 10, None, 16)
