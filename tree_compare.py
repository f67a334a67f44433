"""The sparse path's host-facing numbers for one checkout of the port.

    python3 tree_compare.py --root DIR [--tf32] [--micro | --train]

Imports ``tdr_torch`` from the checkout at ``DIR`` (this one, or another
one unpacked beside it, such as a parent commit under ``_archive/``) and
``chip_smoke.py``'s functions from this checkout, so that two trees are
measured by the same code.  Run it as a script, not with ``-m``, so that
``DIR``'s package is the one imported.  On the full 268,022-document corpus
and its 2,000 queries it prints, after the card's name and power limit:

* K1 at es Q = 256 and Q = 1 (``chip_smoke.k1_device_times``): device
  kernels per ``tail_compact`` call, the device time of its
  ``tail_compact`` kernel and the call's time;
* the sparse and PRF passes through the router (median of 7 host-clock
  passes after a warm one), 64 single es queries one at a time, and the en
  model alone on 768 queries in three batches of 256; then the device
  events of one traced sparse and one traced PRF pass;
* with ``--tf32``: phase 9c (``chip_smoke.tf32_phase``), each check's
  verdict, after 9a's f32-head build and a dense build;
* with ``--micro`` (this checkout's package only): in one process and
  alternated, K2's phase-2 rescore at en Q = 256 in three forms (bmm,
  bmm inside ``ieee_f32``, the elementwise product and sum) and two ways
  to read the current stream's handle, host time of ``ieee_f32``'s enter
  and exit;
* with ``--train``, only phase 13d instead (``parallel_check.py``'s
  ``train_phase``: the sharded train step against the unsharded one over
  every visible card, then the CLI's ``train --mesh 2x2``).

Compare two trees only within one call on one card, in an interleaved
order of processes (change, parent, parent, change, ...).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def _load(root):
    """This checkout's ``chip_smoke`` functions, with ``tdr_torch`` imported
    from ``root``."""
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_functions", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import tdr_torch

    if not os.path.abspath(tdr_torch.__file__).startswith(root):
        raise RuntimeError(f"tdr_torch came from {tdr_torch.__file__}, "
                           f"not {root}")
    return cs


def micro(cs, en, en_toks, tag):
    """K2's rescore forms and the host costs of the pin and the stream
    handle, alternated in this process."""
    import contextlib

    import torch
    from tdr_torch.ops.precision import ieee_f32

    qids, qw = en.encode_query_tokens(en_toks[:256])
    index = en.index
    slot = index.head_slot[qids.clamp(0, index.vocab_size - 1).long()]
    slot0 = torch.where(slot >= 0, slot, 0)
    w = torch.where(slot >= 0, qw, 0.0).to(index.head_rows.dtype).float()
    gen = torch.Generator(device=qids.device).manual_seed(0)
    cols = torch.randint(0, index.n_docs, (qids.shape[0], 80),
                         generator=gen, device=qids.device)
    head = index.head_rows

    def bmm(ctx):
        def run():
            with ctx():
                rows = head[slot0[:, :, None], cols[:, None, :]].float()
                return torch.bmm(w[:, None, :], rows)[:, 0]
        return run

    def elementwise():
        rows = head[slot0[:, :, None], cols[:, None, :]]
        return (w[:, :, None] * rows).sum(dim=1)

    forms = (("bmm", bmm(contextlib.nullcontext)),
             ("bmm in ieee_f32", bmm(ieee_f32)), ("elementwise", elementwise))
    ref = forms[0][1]()
    for name, run in forms[1:]:
        err = (run() - ref).abs().max().item()
        cs.say(f"[tree {tag} micro] rescore {name}: max |difference| from "
               f"bmm {err:.3e}")
    times = {name: [] for name, _ in forms}
    for rnd in range(4):
        for name, run in (forms if rnd % 2 == 0 else forms[::-1]):
            times[name].append(cs.time_ms(run, 200))
    for name, t in times.items():
        cs.say(f"[tree {tag} micro] rescore {name} at Q={qids.shape[0]} "
               f"T={qids.shape[1]} C=80: {statistics.median(t):.5f} ms "
               f"(rounds {[round(x, 5) for x in t]})")

    dev = head.device

    def pin():
        with ieee_f32():
            pass

    host = (("ieee_f32 enter+exit", pin),
            ("torch.cuda.current_stream(dev).cuda_stream",
             lambda: torch.cuda.current_stream(dev).cuda_stream),
            ("torch._C._cuda_getCurrentRawStream(index)",
             lambda: torch._C._cuda_getCurrentRawStream(dev.index)))
    for name, fn in host:
        for _ in range(100):
            fn()
        t0 = time.perf_counter()
        for _ in range(10_000):
            fn()
        cs.say(f"[tree {tag} micro] {name}: "
               f"{(time.perf_counter() - t0) / 10_000 * 1e6:.2f} us (host)")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE, help="the checkout to measure")
    ap.add_argument("--tf32", action="store_true",
                    help="also run phase 9c, each check's verdict")
    ap.add_argument("--micro", action="store_true",
                    help="also time the rescore forms and host costs")
    ap.add_argument("--train", action="store_true",
                    help="only phase 13d, the sharded train step")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    cs = _load(root)

    import torch
    from tdr_torch.data import SyntheticSpec, synthetic_corpus
    from tdr_torch.models.dense import DenseModel
    from tdr_torch.models.encoder import init_encoder
    from tdr_torch.ops import cuda_build
    from tdr_torch.rank import LanguageRouter, build_language_models
    from tdr_torch.rank.router import _gather_results
    from tdr_torch.text.fast import fast_tokenize_texts
    from tdr_torch.utils.config import DenseConfig, IndexConfig

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this tool needs a GPU")
    tag = os.path.relpath(root, HERE)
    cs.say(f"[tree {tag}] {cs.card_line()}; torch {torch.__version__}")
    cuda_build.build(force=True)
    corpus, queries = synthetic_corpus(SyntheticSpec(
        n_docs=cs.N_DOCS, n_queries=2000, seed=42, hard=True))
    if args.train:
        spec = importlib.util.spec_from_file_location(
            "parallel_check_functions", os.path.join(HERE, "parallel_check.py"))
        pc = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(pc)
        cs.say(f"[tree {tag}] phase 13d")
        pc.train_phase(cs, corpus, DenseConfig())
        return
    models = build_language_models(
        corpus, index_cfg=IndexConfig(head_budget_bytes=cs.HEAD_BUDGET),
        device=cs.DEVICE)
    qs, langs = queries.queries, queries.langs
    router = LanguageRouter(models, query_batch=256)

    es = models["es"]
    es_qs = [q for q, l in zip(qs, langs) if l == "es"]
    for n in (256, 1):
        toks = fast_tokenize_texts(es_qs[:n], "es")
        qids, qw = es.encode_query_tokens(toks + [[]] * (n - len(toks)))
        kernel_ms, call_ms, per_call = cs.k1_device_times(
            es.index, qids, qw, cs.k1_budget(es.index), one_launch=False)
        cs.say(f"[tree {tag}] K1 es Q={n}: {per_call:.0f} device kernels a "
               f"call; kernel_ms={kernel_ms:.5f} (device, torch.profiler) "
               f"call_ms={call_ms:.5f}")

    for m in models.values():
        m._doc_major()
    prf = LanguageRouter({l: dataclasses.replace(m, prf=True)
                          for l, m in models.items()}, query_batch=256)
    en = models["en"]
    en_toks = fast_tokenize_texts([q for q, l in zip(qs, langs)
                                   if l == "en"][:768], "en")

    def en_alone():
        pend = [en.topk_tokens_async(en_toks[s:s + 256], 10, pad_to=256)
                for s in range(0, len(en_toks), 256)]
        _gather_results([p[0] for p in pend], [p[1] for p in pend])

    def singles():
        for q in es_qs[:64]:
            router.retrieve([q], ["es"], k=10)

    sparse_s = None
    for label, run, reps, per in (
            ("sparse pass", lambda: router.retrieve(qs, langs, k=10), 7, 1),
            ("PRF pass", lambda: prf.retrieve(qs, langs, k=10), 7, 1),
            ("single es query", singles, 3, len(es_qs[:64])),
            ("en alone, 768 queries", en_alone, 7, 1)):
        med, times = cs.timed(run, reps)
        sparse_s = med if sparse_s is None else sparse_s
        cs.say(f"[tree {tag}] {label}: median {med / per * 1e3:.3f} ms of "
               f"{[round(t / per * 1e3, 3) for t in times]}")
    cs.profile_pass(f"{tag} sparse", lambda: router.retrieve(qs, langs, k=10))
    cs.profile_pass(f"{tag} prf", lambda: prf.retrieve(qs, langs, k=10))
    if args.micro:
        micro(cs, en, en_toks, tag)
    if args.tf32:
        del router, prf, models, en, es
        gc.collect()
        torch.cuda.empty_cache()
        cfg = DenseConfig()
        dense = DenseModel.build(init_encoder(cfg, seed=0, device=cs.DEVICE),
                                 cfg, corpus.texts, corpus.docids, batch=256)
        q_enc = dense.encode_queries(qs)
        _, f32_models, f32_ref = cs.f32_heads_phase(corpus, queries, 1,
                                                    sparse_s)
        bench_emb, bench_q = cs.bench_embeddings()
        cs.tf32_phase(f32_models, f32_ref, dense.flat, q_enc, bench_emb,
                      bench_q, strict=False)
    cs.say(f"[tree {tag}] done")


if __name__ == "__main__":
    main()
