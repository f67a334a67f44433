# Frozen copy of the port's synthetic corpus generator
# (tdr_torch/data/synthetic.py), kept here so that the benchmark's inputs do
# not move when the program changes.  The Corpus and QuerySet records are
# the plain ones below, and the document loop draws each partition's
# signature insertions in one call (the same random stream, so the same
# corpus: tests/test_tdrbench_generator.py holds it to the original).  One
# knob is the benchmark's own: ``doc_len_by_lang``, a mean document length
# for each language (left empty, the corpus is the original's).
"""Deterministic synthetic multilingual corpus + query generator.

The reference's dataset (268k-doc `corpus.json`, Kaggle CSVs) is not
redistributable and is absent here, so tests and benchmarks run on synthetic
corpora with the same *shape*: 7 languages with the reference's per-language
proportions (final_implementation.py:310-318), Zipf-distributed vocabulary,
long documents, and queries that reference their target document's signature
terms (so Recall@k is a meaningful, non-trivial score).

Everything is seeded — same spec ⇒ byte-identical corpus.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import zlib

import numpy as np



@dataclass
class Corpus:
    docids: List[str]
    texts: List[str]
    langs: List[str]


@dataclass
class QuerySet:
    query_ids: List[str]
    queries: List[str]
    langs: List[str]
    positive_docs: List[str]

# reference per-language corpus proportions (268,022 total)
REF_PROPORTIONS = {
    "en": 207_363 / 268_022,
    "it": 11_250 / 268_022,
    "es": 11_019 / 268_022,
    "de": 10_992 / 268_022,
    "fr": 10_676 / 268_022,
    "ar": 8_829 / 268_022,
    "ko": 7_893 / 268_022,
}

_LATIN_SYLLABLES = "ba be bi bo bu da de di do du ka ke ki ko ku la le li lo lu ma me mi mo mu na ne ni no nu pa pe pi po pu ra re ri ro ru sa se si so su ta te ti to tu va ve vi vo vu za ze zi zo zu".split()
_AR_CHARS = list("ابتثجحخدذرزسشصضطظعغفقكلمنهوي")
_KO_ONSET = list("가나다라마바사아자차카타파하고노도로모보소오조초코토포호구누두루무부수우주추쿠투푸후")


def _make_word(rng: np.random.RandomState, lang: str) -> str:
    if lang == "ar":
        n = rng.randint(3, 7)
        return "".join(rng.choice(_AR_CHARS) for _ in range(n))
    if lang == "ko":
        n = rng.randint(2, 4)
        return "".join(rng.choice(_KO_ONSET) for _ in range(n))
    n = rng.randint(2, 5)
    return "".join(rng.choice(_LATIN_SYLLABLES) for _ in range(n))


# vocab sizes above this use the vectorized enumerative generator; below it
# the original per-word rejection loop runs, keeping every existing seed's
# corpus byte-identical
_BULK_VOCAB_THRESHOLD = 20_000


def _bulk_words(lang: str, count: int, seed: int) -> List[str]:
    """Reference-scale vocabulary generation: enumerate the syllable
    product space per word length in a seeded shuffled order — unique by
    construction and vectorized.  The rejection loop above degenerates as
    ``count`` approaches a length class's space (nearly every draw is a
    repeat); this pays one ``permutation(space)`` per length instead."""
    if lang == "ar":
        chars, lens = _AR_CHARS, (3, 4, 5, 6)
    elif lang == "ko":
        chars, lens = _KO_ONSET, (2, 3)
    else:
        chars, lens = _LATIN_SYLLABLES, (2, 3, 4)
    rng = np.random.RandomState(
        (seed * 1000003 + zlib.crc32(lang.encode()) + 77) % (2**31))
    arr = np.asarray(chars, dtype=object)
    out: List[str] = []
    for k in lens:
        if len(out) >= count:
            break
        space = len(chars) ** k
        take = min(count - len(out), space)
        idx = rng.permutation(space)[:take].astype(np.int64)
        cols = []
        for _ in range(k):
            cols.append(arr[idx % len(chars)])
            idx //= len(chars)
        out.extend("".join(parts) for parts in zip(*cols))
    if len(out) < count:
        raise ValueError(
            f"{lang} syllable space exhausted at {len(out)} < {count}")
    return out


# reference-scale vocabulary targets (SURVEY §7 "Hard parts": the en vocab
# realizes >=200k unigram index terms; the latin languages' preprocessing
# adds bigrams, inflating their realized index vocabs to >=500k — the
# regime that forced the reference into 208 en term_freqs pickle shards,
# final_implementation.py:228)
STRESS_VOCAB = {
    "en": 250_000,
    "de": 60_000, "es": 60_000, "fr": 60_000, "it": 60_000,
    "ar": 40_000, "ko": 40_000,
}


_TYPO_CHAR = {"ar": "ح", "ko": "흐"}


def _typo(rng: np.random.RandomState, word: str, lang: str) -> str:
    """Corrupt one character (usually making the term out-of-vocabulary)."""
    ch = _TYPO_CHAR.get(lang, "x")
    if len(word) < 2:
        return word + ch
    i = rng.randint(0, len(word))
    return word[:i] + ch + word[i + 1:]


@dataclass(frozen=True)
class SyntheticSpec:
    n_docs: int = 2000
    n_queries: int = 200
    seed: int = 0
    langs: Sequence[str] = ("ar", "de", "en", "es", "fr", "it", "ko")
    ref_proportions: bool = True
    vocab_per_lang: int = 4000
    doc_len_mean: int = 120          # tokens per document (pre-preprocess)
    query_len: int = 6
    signature_terms: int = 4         # per-doc distinctive terms
    noise_query_terms: int = 2       # common terms mixed into each query
    sentences_per_doc: int = 1       # >1 inserts '.' sentence boundaries so
                                     # the sentence-level pipeline (team_run1
                                     # '{docid}_{idx}' explode) has real work;
                                     # token content is unchanged (preprocess
                                     # strips punctuation)

    # -- hard mode (de-saturated eval) --------------------------------------
    # Docs are generated in near-duplicate groups sharing all but one
    # signature term; queries use the shared terms, include the target's
    # unique term only with ``unique_term_prob``, and suffer per-term typo
    # corruption.  Latin languages share part of their rare vocabulary so
    # cross-language collisions exist.  Recall@10 lands well below 1.0 and
    # MOVES when ranking quality changes.
    hard: bool = False
    group_size: int = 16             # docs per near-duplicate group
    unique_term_prob: float = 0.5    # P(query carries the disambiguating term)
    typo_prob: float = 0.15          # per-query-term corruption probability

    # -- vocab-stress mode (reference-scale vocabulary) ----------------------
    # Per-language vocab counts from STRESS_VOCAB (en 250k, latin 60k —
    # bigram augmentation inflates their realized index vocabs to >=500k,
    # ar/ko 40k) so the dominant partition's head CANNOT cover its vocab:
    # the tail CSR, the Pallas compactor, and the waterfill all carry real
    # load (VERDICT r3 #3: the 4000-term default skipped all of it).
    vocab_stress: bool = False

    # -- per-language document lengths ---------------------------------------
    # ((lang, mean tokens per document before preprocessing), ...): a
    # language listed here takes its own mean in place of doc_len_mean
    doc_len_by_lang: Tuple[Tuple[str, int], ...] = ()


def synthetic_corpus(spec: SyntheticSpec = SyntheticSpec()) -> Tuple[Corpus, QuerySet]:
    rng = np.random.RandomState(spec.seed)
    langs = list(spec.langs)

    # per-language doc counts
    if spec.ref_proportions:
        props = np.array([REF_PROPORTIONS.get(l, 1.0 / len(langs)) for l in langs])
        props = props / props.sum()
    else:
        props = np.full(len(langs), 1.0 / len(langs))
    counts = np.maximum(1, (props * spec.n_docs).astype(int))
    # absorb the rounding difference into the largest partition; keep every
    # language at >= 1 doc (tiny corpora may exceed n_docs slightly)
    counts[int(np.argmax(counts))] += spec.n_docs - counts.sum()
    counts = np.maximum(counts, 1)

    # per-language vocab: common pool (Zipf) + unique signature pool
    vocabs: Dict[str, List[str]] = {}
    bulk_langs: set = set()
    for lang in langs:
        n_words = (STRESS_VOCAB.get(lang, spec.vocab_per_lang)
                   if spec.vocab_stress else spec.vocab_per_lang)
        if n_words > _BULK_VOCAB_THRESHOLD:
            vocabs[lang] = _bulk_words(lang, n_words, spec.seed)
            bulk_langs.add(lang)
            continue
        seen, words = set(), []
        wrng = np.random.RandomState(
            (spec.seed * 1000003 + zlib.crc32(lang.encode())) % (2**31))
        while len(words) < n_words:
            w = _make_word(wrng, lang)
            if w not in seen:
                seen.add(w)
                words.append(w)
        vocabs[lang] = words

    if spec.hard:
        # cross-language vocabulary collisions: latin languages share the
        # tail 10% of their rare pools, so a query's signature terms also
        # occur in other languages' documents (stress for the single-index
        # path and for language routing).
        latin = [l for l in langs if l not in ("ar", "ko")]
        if len(latin) > 1:
            srng = np.random.RandomState((spec.seed * 7 + 11) % (2**31))
            # == vocab_per_lang // 10 in the default mode; per-language
            # counts differ under vocab_stress, so share the smallest tenth
            n_shared = max(1, min(len(vocabs[l]) for l in latin) // 10)
            # whenever the bulk generator built a vocab it ENUMERATES the
            # short syllable spaces, so a randomly drawn shared word is
            # certain to collide with the kept (Zipf-common) vocab — which
            # would turn "rare" signature terms into high-frequency body
            # terms and quietly soften hard-mode recall.  Key the guard on
            # bulk generation itself (vocab_stress OR vocab_per_lang >
            # 20k), not the stress flag; small rejection-sampled vocabs
            # keep their draws byte-identical.
            kept: set = set()
            for l in latin:
                if l in bulk_langs:
                    kept.update(vocabs[l][:-n_shared])
            shared_pool: List[str] = []
            seen_sh = set()
            while len(shared_pool) < n_shared:
                w = _make_word(srng, "en")
                if w not in seen_sh and w not in kept:
                    seen_sh.add(w)
                    shared_pool.append(w)
            for l in latin:
                vocabs[l] = vocabs[l][:-n_shared] + shared_pool

    docids: List[str] = []
    texts: List[str] = []
    doc_langs: List[str] = []
    signatures: List[List[str]] = []
    shared_of: List[List[str]] = []      # hard mode: group-shared sig terms
    unique_of: List[str] = []            # hard mode: disambiguating term

    did = 0
    len_of = dict(spec.doc_len_by_lang)
    for lang, cnt in zip(langs, counts):
        cnt = int(cnt)
        mean = len_of.get(lang, spec.doc_len_mean)
        vocab = vocabs[lang]
        n_common = len(vocab) // 2
        common = np.asarray(vocab[:n_common], dtype=object)
        rare = np.asarray(vocab[n_common:], dtype=object)
        zipf_p = 1.0 / np.arange(1, n_common + 1)
        zipf_p /= zipf_p.sum()
        # vectorized draws for the whole language partition: one big Zipf
        # pool split into per-doc bodies (the per-doc rng.choice-with-p loop
        # dominated generation time at bench scale)
        lengths = np.maximum(
            10, rng.normal(mean, mean / 4, cnt).astype(int))
        pool = rng.choice(len(common), size=int(lengths.sum()), p=zipf_p)
        if spec.hard:
            # near-duplicate groups: group members share all signature terms
            # but one; only the unique term (present in the query with
            # probability unique_term_prob) separates the target from its
            # group_size-1 distractors.
            group = np.arange(cnt) // max(1, spec.group_size)
            shared_idx = rng.randint(
                0, len(rare), (int(group.max()) + 1, spec.signature_terms - 1))
            uniq_idx = rng.randint(0, len(rare), cnt)
            sig_idx = np.concatenate([shared_idx[group], uniq_idx[:, None]], axis=1)
        else:
            sig_idx = rng.randint(0, len(rare), (cnt, spec.signature_terms))
        sig_reps = rng.randint(2, 5, (cnt, spec.signature_terms))
        offsets = np.concatenate([[0], np.cumsum(lengths)])
        # the signature insertions of the whole partition, drawn in one call:
        # the same stream as one randint(0, len(body)) per insertion, body
        # growing by one each time
        n_ins = sig_reps.sum(axis=1)
        firsts = np.repeat(np.cumsum(n_ins) - n_ins, n_ins)
        highs = np.repeat(lengths, n_ins) + np.arange(int(n_ins.sum())) - firsts
        pos = rng.randint(0, highs).tolist() if len(highs) else []
        ins = np.repeat(rare[sig_idx].ravel(), sig_reps.ravel()).tolist()
        words = common[pool].tolist()
        sig_rows = rare[sig_idx].tolist()
        offsets, n_ins = offsets.tolist(), n_ins.tolist()
        c = 0
        for i in range(cnt):
            body = words[offsets[i]:offsets[i + 1]]
            for k in range(c, c + n_ins[i]):
                body.insert(pos[k], ins[k])
            c += n_ins[i]
            sig = list(dict.fromkeys(sig_rows[i]))
            docids.append(f"doc-{lang}-{did}")
            if spec.sentences_per_doc > 1:
                ns = min(spec.sentences_per_doc, max(1, len(body)))
                cuts = np.linspace(0, len(body), ns + 1).astype(int)
                texts.append(". ".join(
                    " ".join(body[a:b]) for a, b in zip(cuts[:-1], cuts[1:])
                    if b > a))
            else:
                texts.append(" ".join(body))
            doc_langs.append(lang)
            signatures.append(sig)
            if spec.hard:
                shared_of.append(list(dict.fromkeys(sig_rows[i][:-1])))
                unique_of.append(sig_rows[i][-1])
            did += 1

    corpus = Corpus(docids, texts, doc_langs)

    # queries: signature terms of a random target doc + common-noise terms
    q_ids: List[str] = []
    q_texts: List[str] = []
    q_langs: List[str] = []
    q_pos: List[str] = []
    # each language's common words as an array, made once (choice draws
    # the same randint(0, n_common, size) from a list or an array)
    noise = {l: np.asarray(v[: len(v) // 2], dtype=object)
             for l, v in vocabs.items()}
    for qi in range(spec.n_queries):
        t = rng.randint(0, len(docids))
        lang = doc_langs[t]
        vocab = vocabs[lang]
        n_common = len(vocab) // 2
        if spec.hard:
            terms = list(shared_of[t])
            if rng.rand() < spec.unique_term_prob:
                terms.append(unique_of[t])
            terms += list(rng.choice(noise[lang], size=spec.noise_query_terms))
            terms = [_typo(rng, w, lang) if rng.rand() < spec.typo_prob else w
                     for w in terms]
        else:
            terms = list(signatures[t])[: spec.query_len]
            terms += list(rng.choice(noise[lang], size=spec.noise_query_terms))
        rng.shuffle(terms)
        q_ids.append(str(qi))
        q_texts.append(" ".join(terms))
        q_langs.append(lang)
        q_pos.append(docids[t])
    queries = QuerySet(q_ids, q_texts, q_langs, positive_docs=q_pos)
    return corpus, queries
