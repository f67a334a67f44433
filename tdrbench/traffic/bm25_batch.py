"""Kind ``bm25_batch``: the sparse main path as a batch user drives it.

One client in a closed loop sends sets of queries, each with its language,
to ``LanguageRouter.retrieve_with_scores(queries, langs, k)`` and waits for
the lists.  The corpus, a pool of queries and the sequence of sets come
from the seed (the frozen generator, ``harness/synthetic.py``).  A mix file
gives:

    queries_per_call  queries in one set
    pool              queries generated to draw the sets from; every set
                      holds each language in the corpus's proportions
                      (the same counts in each set, drawn from the pool's
                      queries of that language, in a seeded order)
    warmup_calls      sets sent during set-up (drawn apart from the
                      window's)
    check_calls       sets whose every answer is held to the reference
                      (the first and the last of the window, the rest
                      drawn from the seed)

``correct`` compares the answers of the checked sets with the reference
(``reference/text.py``, ``reference/bm25.py``) rebuilt from the raw texts.
"""

from __future__ import annotations

import gc
import os
import time
from typing import Dict, List, Optional

import numpy as np

from tdrbench.harness.synthetic import SyntheticSpec, synthetic_corpus
from tdrbench.harness.trace import Tracing, span

HALF_ULP = 2.0 ** -8      # bfloat16's largest relative rounding error
F32 = 1e-5                # float32 statistics and sums, with room
# (the configuration's score_rel_bound is HALF_ULP + F32)


def corpus_spec(config: dict, n_queries: int, seed: int) -> SyntheticSpec:
    c = config["corpus"]
    return SyntheticSpec(
        n_docs=config["n_docs"], n_queries=n_queries, seed=seed % (2**31 - 1),
        langs=tuple(c["langs"]), vocab_stress=c["vocab_stress"],
        doc_len_by_lang=tuple(sorted(c["doc_len_mean"].items())),
        hard=c["hard"])


class Run:
    """One run of the kind: ``setup``, ``window``, ``end_to_end``,
    ``release``, ``check``; then ``layer_inputs`` for the readers.
    ``head_dtype`` overrides the configuration's head type (the control
    runs the program's int8 heads)."""

    def __init__(self, config: dict, mix: dict, seed: int, device: str = "cuda",
                 head_dtype: Optional[str] = None):
        self.config, self.mix, self.seed, self.device = config, mix, seed, device
        self.head_dtype = head_dtype or config["index"]["head_dtype"]
        self.k = config["top_k"]
        self.router = None

    # -- set-up ------------------------------------------------------------

    def make_inputs(self) -> None:
        mix = self.mix
        self.corpus, pool = synthetic_corpus(
            corpus_spec(self.config, mix["pool"], self.seed))
        self.pool_texts, self.pool_langs = pool.queries, pool.langs
        rng = np.random.RandomState(
            np.random.SeedSequence([self.seed, 1]).generate_state(1)[0])
        n = mix["queries_per_call"]
        by: Dict[str, List[int]] = {}
        for i, l in enumerate(pool.langs):
            by.setdefault(l, []).append(i)
        langs = sorted(by)
        docs = self.config["per_lang_docs"]
        w = np.array([docs[l] for l in langs], np.float64)
        # the same count of each language in every set (largest remainder)
        share = np.floor(w / w.sum() * n).astype(int)
        rest = w / w.sum() * n - share
        share[np.argsort(-rest, kind="stable")[: n - share.sum()]] += 1

        def draw():
            out = np.concatenate([rng.choice(by[l], c, replace=False)
                                  for l, c in zip(langs, share)])
            return rng.permutation(out)

        self.warm_sets = [draw() for _ in range(mix["warmup_calls"])]
        self.sets = [draw() for _ in range(mix["distinct_sets"])]

    def build(self) -> None:
        import dataclasses

        from tdr_torch.rank import LanguageRouter, build_language_models
        from tdr_torch.utils.config import BM25Config, IndexConfig

        cfg = self.config
        index_cfg = IndexConfig(head_budget_bytes=cfg["head_budget_bytes"],
                                head_dtype=self.head_dtype)
        bm = cfg["bm25"]
        models = build_language_models(
            self.corpus, bm25=BM25Config(k1=bm["k1"], b=bm["b"],
                                         dl_scaled_by_b=bm["dl_scaled_by_b"],
                                         idf_variant=bm["idf_variant"]),
            index_cfg=dataclasses.replace(index_cfg), device=self.device)
        r = cfg["router"]
        self.router = LanguageRouter(models, query_batch=r["query_batch"],
                                     query_buckets=tuple(r["query_buckets"]))

    def call(self, idx: np.ndarray):
        texts = [self.pool_texts[i] for i in idx]
        langs = [self.pool_langs[i] for i in idx]
        return self.router.retrieve_with_scores(texts, langs, k=self.k)

    def setup(self) -> None:
        t = [time.perf_counter()]
        self.make_inputs()
        t.append(time.perf_counter())
        self.build()
        t.append(time.perf_counter())
        self.warm_ms = []
        for s in self.warm_sets:
            a = time.perf_counter()
            self.call(s)
            self.warm_ms.append((time.perf_counter() - a) * 1e3)
        t.append(time.perf_counter())
        self.setup_parts = dict(zip(("inputs", "build", "warm-up"),
                                    np.diff(t)))

    # -- the window --------------------------------------------------------

    def window(self, seconds: float, tracing: Optional[Tracing] = None
               ) -> None:
        """Calls until ``seconds`` have passed.  The answers of the calls
        that ``check`` reads are kept (the first, the last, and a uniform
        sample of the rest drawn from the seed as the calls come), the
        others dropped, as a client would."""
        tracing = tracing or Tracing(False, seconds, seconds)
        self.calls: List[int] = []           # index into self.sets
        self.lat: List[float] = []
        self.kept: Dict[int, tuple] = {}
        self.short = 0
        self.traced_from = None
        self.traced_at = 0.0
        sample: List[int] = []
        n_sample = max(self.mix["check_calls"] - 2, 0)
        rng = np.random.RandomState(
            np.random.SeedSequence([self.seed, 2]).generate_state(1)[0])
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            i = len(self.calls)
            elapsed = time.perf_counter() - t0
            if tracing.due(elapsed) and self.traced_from is None:
                self.traced_from, self.traced_at = i, elapsed
            j = i % len(self.sets)
            with span("tdrbench.call"):
                a = time.perf_counter()
                res = self.call(self.sets[j])
                self.lat.append(time.perf_counter() - a)
            self.calls.append(j)
            self.short += sum(len(d) != self.k for d in res[0])
            if i >= 2:                   # call i-1 joins the sample
                r = rng.randint(0, i - 1)
                if len(sample) < n_sample:
                    sample.append(i - 1)
                elif r < n_sample:
                    self.kept.pop(sample[r], None)
                    sample[r] = i - 1
                else:
                    self.kept.pop(i - 1, None)
            self.kept[i] = res
        self.window_s = time.perf_counter() - t0

    def end_to_end(self) -> Dict[str, float]:
        n = sum(len(self.sets[j]) for j in self.calls)
        lat = np.repeat(np.array(self.lat),
                        [len(self.sets[j]) for j in self.calls])
        return {"query_p95_ms": float(np.percentile(lat, 95)) * 1e3}

    def diagnostics(self) -> str:
        lat = np.array(self.lat) * 1e3
        q = np.percentile(lat, [0, 25, 50, 75, 95, 100])
        n = sum(len(self.sets[j]) for j in self.calls)
        return (f"{n / self.window_s!r} queries/s over the window; "
                f"{len(lat)} calls, ms a call: min {q[0]:.1f} q1 {q[1]:.1f} "
                f"median {q[2]:.1f} q3 {q[3]:.1f} p95 {q[4]:.1f} max "
                f"{q[5]:.1f}; first ten {np.round(lat[:10], 1).tolist()}; "
                f"warm-up {np.round(self.warm_ms, 1).tolist()}")

    def attempted_failed(self):
        n = sum(len(self.sets[j]) for j in self.calls)
        return n, self.short

    def text_span(self, max_calls: int = 64) -> float:
        """Host seconds a query of the window's sets spends in the text
        layer: the harness's own call of ``fast_tokenize_texts`` on each
        set's queries, grouped by language as the router groups them."""
        from tdr_torch.text.fast import fast_tokenize_texts

        n, t = 0, 0.0
        for j in self.calls[:max_calls]:
            groups: Dict[str, List[str]] = {}
            for i in self.sets[j]:
                groups.setdefault(self.pool_langs[i], []).append(
                    self.pool_texts[i])
            a = time.perf_counter()
            for lang, texts in groups.items():
                fast_tokenize_texts(texts, lang)
            t += time.perf_counter() - a
            n += len(self.sets[j])
        return t / max(n, 1)

    def release(self) -> None:
        self.router = None
        gc.collect()
        if self.device != "cpu":
            import torch

            torch.cuda.empty_cache()

    # -- correctness ---------------------------------------------------------

    def checked_calls(self) -> List[int]:
        return sorted(self.kept)

    def reference(self):
        """The reference's per-language index and BM25 (built once)."""
        if getattr(self, "_ref", None) is None:
            import torch

            from tdrbench.reference.bm25 import BM25Reference
            from tdrbench.reference.text import encode_corpora

            bm = self.config["bm25"]
            rows: Dict[str, List[int]] = {}
            for i, l in enumerate(self.corpus.langs):
                rows.setdefault(l, []).append(i)
            ixs = encode_corpora(
                {lang: [self.corpus.texts[i] for i in r]
                 for lang, r in rows.items()}, min(8, os.cpu_count() or 1))
            self.doc_at = {}
            ref = {}
            for lang, r in sorted(rows.items()):
                ix = ixs.pop(lang)
                ref[lang] = (ix, BM25Reference(
                    ix, bm["k1"], bm["b"], bm["dl_scaled_by_b"],
                    bm["idf_variant"], self.device))
                for row, i in enumerate(r):
                    self.doc_at[self.corpus.docids[i]] = (lang, row)
            self._ref = ref
            if self.device != "cpu":
                torch.cuda.synchronize()
        return self._ref

    def check(self, answers: Optional[Dict[int, tuple]] = None
              ) -> Dict[str, tuple]:
        """The numbers compared, each as (value, limit): computed over every
        answer of the checked calls.  ``answers`` (call -> answers) replaces
        the window's: the control's answers to the same sets."""
        from tdrbench.reference.bm25 import block_size, kth_and_at
        from tdrbench.reference.text import encode_queries

        answers = answers if answers is not None else self.kept
        ref = self.reference()
        qs: Dict[str, List[tuple]] = {}          # lang -> (text, docs, vals)
        bad = 0
        for c in self.checked_calls():
            docs, vals = answers[c]
            for i, d, v in zip(self.sets[self.calls[c]], docs, vals):
                lang = self.pool_langs[i]
                where = [self.doc_at.get(x, (None, -1)) for x in d]
                want = min(self.k, ref[lang][0].n_docs)
                if (len(d) != want or len(set(d)) != len(d)
                        or any(l != lang for l, _ in where)):
                    bad += 1
                rows = np.full(self.k, -1, np.int64)
                rows[: len(where)] = [r if l == lang else -1 for l, r in where]
                qs.setdefault(lang, []).append(
                    (self.pool_texts[i], rows, np.asarray(v[: self.k], np.float64)))
        # a bfloat16 head row holds each weight within HALF_ULP of it, so a
        # score within HALF_ULP of the reference's and every listed document
        # within (1 - HALF_ULP) / (1 + HALF_ULP) of the k-th best; F32 covers
        # the float32 statistics and sums
        floor = (1 - HALF_ULP) / (1 + HALF_ULP) * (1 - F32)
        misranked, rel_max = 0, 0.0
        for lang, items in qs.items():
            ix, bm = ref[lang]
            terms = encode_queries([t for t, _, _ in items], ix)
            step = block_size(ix.n_docs, len({t for q in terms for t in q}),
                              16e9 if self.device != "cpu" else 2e8)
            for s in range(0, len(items), step):
                blk = items[s:s + step]
                scores = bm.scores(terms[s:s + step])
                rows = np.stack([r for _, r, _ in blk])
                vals = np.stack([v for _, _, v in blk])
                kth, at = kth_and_at(scores, rows, self.k)
                del scores
                named = (rows >= 0) & np.isfinite(vals)
                at = np.where(named, at, 0.0)
                misranked += int((named & (at < kth[:, None] * floor)).sum())
                err = np.abs(vals - at) / np.maximum(at, 1e-30)
                rel_max = max(rel_max, float(np.max(
                    np.where(named & ((at > 0) | (vals != 0)), err, 0.0),
                    initial=0.0)))
        lim = self.mix["limits"]
        return {"bad_answers": (bad, 0), "misranked": (misranked, 0),
                "score_rel_max": (rel_max, lim["score_rel_max"])}

    # -- what the per-layer readers take ----------------------------------

    def layer_inputs(self) -> Dict:
        """What the traced run's readers take: the queries answered in the
        traced part of the window, and the rate of the part before it (the
        queries answered there over its host seconds; None where the trace
        took the whole window)."""
        before = sum(len(self.sets[j]) for j in self.calls[:self.traced_from])
        return {"queries": sum(len(self.sets[j])
                               for j in self.calls[self.traced_from:]),
                "queries_per_s_untraced": (before / self.traced_at
                                           if self.traced_at > 0 else None)}
