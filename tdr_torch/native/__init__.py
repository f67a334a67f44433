# Copied from tdr/native/__init__.py; only the imports are rewritten.
"""ctypes bindings for the native host tokenizer (libtdrtok.so).

Builds lazily with ``make`` on first use; callers should catch
``NativeUnavailable`` and fall back to the pure-Python pipeline.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional, Sequence, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "libtdrtok.so")


class NativeUnavailable(RuntimeError):
    pass


class _TdrResult(ctypes.Structure):
    _fields_ = [
        ("token_ids", ctypes.POINTER(ctypes.c_int32)),
        ("doc_offsets", ctypes.POINTER(ctypes.c_int64)),
        ("vocab_blob", ctypes.POINTER(ctypes.c_char)),
        ("n_tokens", ctypes.c_int64),
        ("n_docs", ctypes.c_int64),
        ("vocab_blob_len", ctypes.c_int64),
        ("vocab_size", ctypes.c_int32),
    ]


_lib: Optional[ctypes.CDLL] = None
_load_lock = __import__("threading").Lock()


class _TdrCorpusResult(ctypes.Structure):
    _fields_ = [
        ("blob", ctypes.POINTER(ctypes.c_char)),
        ("offsets", ctypes.POINTER(ctypes.c_int64)),
        ("n_docs", ctypes.c_int64),
        ("blob_len", ctypes.c_int64),
        ("error", ctypes.c_char_p),
    ]


class _TdrCountResult(ctypes.Structure):
    _fields_ = [
        ("doc_ids", ctypes.POINTER(ctypes.c_int32)),
        ("term_ids", ctypes.POINTER(ctypes.c_int32)),
        ("tfs", ctypes.POINTER(ctypes.c_float)),
        ("doc_lens", ctypes.POINTER(ctypes.c_int32)),
        ("df", ctypes.POINTER(ctypes.c_int32)),
        ("pair_keys", ctypes.POINTER(ctypes.c_int64)),
        ("nnz", ctypes.c_int64),
        ("n_docs", ctypes.c_int64),
        ("n_pairs", ctypes.c_int64),
        ("vocab_size", ctypes.c_int32),
    ]


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _load_lock:
        return _load_locked()


def _load_locked() -> ctypes.CDLL:
    # serialized: the router's thread pool can race the lazy `make` —
    # concurrent -B rebuilds of the same .so can dlopen a half-written
    # file or relink one already mapped by another thread
    global _lib
    if _lib is not None:
        return _lib
    srcs = [os.path.join(_DIR, f)
            for f in ("tokenizer.cc", "jsonload.cc", "hashenc.cc",
                      "countdocs.cc", "utf8.h")]
    stale = not os.path.exists(_SO) or any(
        os.path.exists(s) and os.path.getmtime(s) > os.path.getmtime(_SO)
        for s in srcs)
    if stale:
        try:
            subprocess.run(["make", "-B", "-C", _DIR], check=True,
                           capture_output=True, timeout=120)
        except (subprocess.SubprocessError, OSError) as e:
            raise NativeUnavailable(f"native tokenizer build failed: {e}")
    try:
        lib = ctypes.CDLL(_SO)
    except OSError as e:
        raise NativeUnavailable(f"cannot load {_SO}: {e}")
    lib.tdr_tokenize_batch.restype = ctypes.POINTER(_TdrResult)
    lib.tdr_tokenize_batch.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32,
    ]
    lib.tdr_free_result.argtypes = [ctypes.POINTER(_TdrResult)]
    lib.tdr_parse_corpus.restype = ctypes.POINTER(_TdrCorpusResult)
    lib.tdr_parse_corpus.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.tdr_free_corpus.argtypes = [ctypes.POINTER(_TdrCorpusResult)]
    lib.tdr_count_docs.restype = ctypes.POINTER(_TdrCountResult)
    lib.tdr_count_docs.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
    ]
    lib.tdr_free_count.argtypes = [ctypes.POINTER(_TdrCountResult)]
    lib.tdr_hash_encode.restype = None
    lib.tdr_hash_encode.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
    ]
    _lib = lib
    return lib


def parse_corpus_json(data: bytes):
    """corpus.json bytes → (docids, texts, langs) via the C++ streaming
    parser (jsonload.cc).  Raises NativeUnavailable if the library is
    missing and ValueError on malformed JSON (callers fall back to
    json.load)."""
    lib = _load()
    res = lib.tdr_parse_corpus(data, len(data))
    try:
        r = res.contents
        if r.error:
            raise ValueError(f"native corpus parse: {r.error.decode()}")
        n = int(r.n_docs)
        offs = np.ctypeslib.as_array(r.offsets, shape=(3 * n + 1,)).copy()
        blob = ctypes.string_at(r.blob, int(r.blob_len))
        # per-field decode beats one whole-blob decode: a single non-BMP
        # char forces CPython's UCS-4 representation on the ENTIRE decoded
        # blob (4 bytes/char + full-width slice copies; measured 5x slower)
        docids, texts, langs = [], [], []
        mv = memoryview(blob)
        try:
            for i in range(n):
                j = 3 * i
                docids.append(str(mv[offs[j]:offs[j + 1]], "utf-8"))
                texts.append(str(mv[offs[j + 1]:offs[j + 2]], "utf-8"))
                langs.append(str(mv[offs[j + 2]:offs[j + 3]], "utf-8"))
        except UnicodeDecodeError as e:   # defensive: callers match ValueError
            raise ValueError(f"native corpus parse: bad utf-8 ({e})") from e
        return docids, texts, langs
    finally:
        lib.tdr_free_corpus(res)


def available() -> bool:
    try:
        _load()
        return True
    except NativeUnavailable:
        return False


def hash_encode_batch(
    texts: Sequence[str],
    vocab_size: int,
    max_len: int = 128,
    ngram_min: int = 3,
    ngram_max: int = 5,
    ngrams_per_word: int = 2,
) -> Tuple[np.ndarray, np.ndarray]:
    """Feature-hash encode (dense encoder ids) → (ids (B, L) int32,
    mask (B, L) float32).  Bit-identical to
    ``tdr.text.hash_tokenizer.encode_batch`` for the corpus's scripts
    (parity pinned in tests/test_native.py); rows are hashed by C++ threads
    straight into the output buffers — the 600k-sentence embedding pass is
    host-hashing bound on the pure-Python path."""
    lib = _load()
    encoded = [t.encode("utf-8") for t in texts]
    offsets = np.zeros(len(texts) + 1, np.int64)
    for i, e in enumerate(encoded):
        offsets[i + 1] = offsets[i] + len(e)
    blob = b"".join(encoded)
    ids = np.zeros((len(texts), max_len), np.int32)
    mask = np.zeros((len(texts), max_len), np.float32)
    lib.tdr_hash_encode(
        blob, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(texts), vocab_size, max_len, ngram_min, ngram_max,
        ngrams_per_word,
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return ids, mask


def count_docs(
    stream: "np.ndarray",
    doc_offsets: "np.ndarray",
    n_unigram: int,
    emit_bigrams: bool,
):
    """(doc, term) counting over a stem-id stream in one native pass —
    replaces the encode pipeline's numpy repeat/pack/np.unique tail
    (countdocs.cc; measured 56 s of the 170 s full-fidelity build on the
    1-core bench host).  → (doc_ids i32, term_ids i32, tfs f32,
    doc_lens i32, df i32, pair_keys i64): COO sorted (doc, term) —
    np.unique(packed) order — with bigram ids assigned in sorted-pair-key
    order starting at ``n_unigram`` (np.unique parity)."""
    lib = _load()
    stream = np.ascontiguousarray(stream, np.int32)
    doc_offsets = np.ascontiguousarray(doc_offsets, np.int64)
    n_docs = len(doc_offsets) - 1
    res = lib.tdr_count_docs(
        stream.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        doc_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n_docs, n_unigram, 1 if emit_bigrams else 0,
    )
    try:
        r = res.contents
        nnz = int(r.nnz)
        npair = int(r.n_pairs)
        doc_ids = np.ctypeslib.as_array(r.doc_ids, shape=(max(nnz, 1),))[:nnz].copy()
        term_ids = np.ctypeslib.as_array(r.term_ids, shape=(max(nnz, 1),))[:nnz].copy()
        tfs = np.ctypeslib.as_array(r.tfs, shape=(max(nnz, 1),))[:nnz].copy()
        doc_lens = np.ctypeslib.as_array(r.doc_lens, shape=(max(n_docs, 1),))[:n_docs].copy()
        df = np.ctypeslib.as_array(
            r.df, shape=(max(int(r.vocab_size), 1),))[: int(r.vocab_size)].copy()
        pair_keys = np.ctypeslib.as_array(
            r.pair_keys, shape=(max(npair, 1),))[:npair].copy()
        return doc_ids, term_ids, tfs, doc_lens, df, pair_keys
    finally:
        lib.tdr_free_count(res)


def tokenize_batch(
    texts: Sequence[str],
    lang_modes: Sequence[str],       # per doc: "l" latin, "a" arabic, "k" korean
    stopwords: Sequence[str],
    ko_suffixes: Sequence[str],
    emit_particles: bool = True,
    min_len_latin: int = 2,
) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """→ (raw token ids (n_tokens,), doc_offsets (n_docs+1,), raw vocab).

    Raw vocab terms are pre-normalization (no stem/lemma); the caller maps
    unique raw terms through the normalizer and re-ids.
    """
    lib = _load()
    blob = "\x00".join([]).encode()  # placeholder
    encoded = [t.encode("utf-8") for t in texts]
    offsets = np.zeros(len(texts) + 1, np.int64)
    for i, e in enumerate(encoded):
        offsets[i + 1] = offsets[i] + len(e)
    text_blob = b"".join(encoded)
    lang_blob = "".join(lang_modes).encode("ascii")
    sw_blob = "\n".join(stopwords).encode("utf-8")
    suf_blob = "\n".join(ko_suffixes).encode("utf-8")

    res = lib.tdr_tokenize_batch(
        text_blob, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(texts), lang_blob, sw_blob, len(sw_blob), suf_blob, len(suf_blob),
        1 if emit_particles else 0, min_len_latin,
    )
    try:
        r = res.contents
        n_tok = int(r.n_tokens)
        token_ids = np.ctypeslib.as_array(r.token_ids, shape=(max(n_tok, 1),))[:n_tok].copy()
        doc_offsets = np.ctypeslib.as_array(r.doc_offsets, shape=(len(texts) + 1,)).copy()
        vocab_bytes = ctypes.string_at(r.vocab_blob, r.vocab_blob_len)
        vocab = vocab_bytes.decode("utf-8").split("\n")[: r.vocab_size]
        return token_ids, doc_offsets, vocab
    finally:
        lib.tdr_free_result(res)
