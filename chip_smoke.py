#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tdr_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                 # the full 268,022-doc run
    python3 chip_smoke.py --queries 500   # fewer queries, same corpus

Phases, in order (any failure exits non-zero and prints no result line):

1. the card's name and power limit; build the CUDA kernels from
   ``tdr_torch/csrc`` (one nvcc per source, in parallel);
2. the synthetic corpus (``hard=True``, ``seed=42``) and one BM25 index per
   language with a 4 GiB total head budget;
3. each kernel against its plain torch version on the card, at the shapes
   of the index just built (fused_head on en; tail_compact on es at Q=256
   and Q=1), with times: kernel, plain, library yardstick, bound;
4. the main path: ``LanguageRouter.retrieve`` over all queries, launch
   counts set to 0 just before one pass and read just after, then timed
   passes; queries/s and hard recall@10;
5. single queries and a query of 8 (the small-batch buckets);
6. a reference check: each language's first batch through the fused path
   against the plain scatter path (full score matrix + stable top-k).

The second-to-last line is the ``{"kernels": [...]}`` JSON; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or ``tdr``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12            # dense bf16 tensor cores
PEAK_F32_FLOPS = 67e12              # f32 outside the tensor cores
RECALL_FLOOR = 0.75
N_DOCS = 268_022                    # the full corpus: never cut
HEAD_BUDGET = 1 << 32               # 4 GiB of dense head, all languages


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def check_tail_compact(index, qids, qw, label):
    """K1 against its plain version at one batch; returns its record."""
    import torch
    from tdr_torch.ops import tail_compact as tc

    budget = min(max(1024, 4 * index.tail_pmax), 16 * index.tail_pmax)
    starts, lens, offs, qw_c, _ = tc.tail_segments(index, qids, qw, budget)
    width = tc.row_width(budget, index.tail_pmax)
    args = (index.postings_doc, index.postings_w, starts, lens, offs, qw_c,
            width, index.n_docs_pad, index.tail_pmax)
    kd, kv = tc.tail_compact_rows(*args)
    pd, pv = tc.tail_compact_rows_plain(*args)
    torch.cuda.synchronize()
    if not (torch.equal(kd, pd) and torch.equal(kv.view(torch.int32),
                                                pv.view(torch.int32))):
        fail(f"tail_compact {label}: kernel differs from plain version")
    Q = qids.shape[0]
    reps = 50
    ms = time_ms(lambda: tc.tail_compact_rows(*args), reps)
    plain_ms = time_ms(lambda: tc.tail_compact_rows_plain(*args), reps)
    seg = int(lens.sum().item())
    n_bytes = (Q * width * 8 + seg * 8
               + 4 * 4 * starts.numel())   # outputs + segments + 4 tables
    bound_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    say(f"[k1 tail_compact {label}] Q={Q} W={width} MT={starts.shape[1]} "
        f"segment entries={seg}: bit-exact; kernel_ms={ms:.5f} "
        f"plain_ms={plain_ms:.5f} library_ms=null bound_ms={bound_ms:.6f} "
        f"(bytes)")
    return dict(name="tail_compact", route="cuda",
                source="tdr_torch/csrc/tail_compact.cu",
                replaces="tdr/ops/pallas_tail.py:152", launches=0,
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes", library_ms=None)


def check_fused_head(index, qids, qw):
    """K2 against its plain version at one batch; returns its record."""
    import torch
    from tdr_torch.ops import fused_head as fh

    head = index.head_rows
    D, N = head.shape
    Q = qids.shape[0]
    Qp = fh._round_up(Q, 128)
    W, _, _ = fh.query_weight_matrix(index, qids, qw)
    Wp = torch.zeros((Qp, D), dtype=head.dtype, device=head.device)
    Wp[:Q] = W.to(head.dtype)
    bias = torch.where(torch.arange(N, device=head.device) < index.n_docs,
                       0.0, fh.NEG).float()
    kern = fh.fused_head_blockmax(Wp, head, bias)
    plain = fh.fused_head_blockmax_plain(Wp, head, bias)
    torch.cuda.synchronize()
    err = (kern - plain).abs()
    tol = 1e-5 * plain.abs() + 1e-6
    if not bool((err <= tol).all()):
        fail(f"fused_head: group maxima differ beyond rtol 1e-5 "
             f"(max abs err {err.max().item():.3e})")
    max_abs_err = float(err[plain > fh.NEG / 2].max().item())
    kv, kr = fh.fused_head_topk(index, qids, qw, top_k=10)
    pv, pr = fh.fused_head_topk(index, qids, qw, top_k=10,
                                blockmax=fh.fused_head_blockmax_plain)
    if not torch.equal(kr, pr) or not torch.equal(kv, pv):
        fail("fused_head: final (vals, rows) differ between kernel and plain")
    reps = 10
    ms = time_ms(lambda: fh.fused_head_blockmax(Wp, head, bias), reps)
    plain_ms = time_ms(lambda: fh.fused_head_blockmax_plain(Wp, head, bias), 3,
                       warmup=1)
    if head.dtype == torch.bfloat16:
        lib_fn = lambda: (torch.mm(Wp, head, out_dtype=torch.float32)  # noqa: E731
                          + bias).view(Qp, -1, 8).amax(-1)
        peak = PEAK_BF16_FLOPS
    else:
        lib_fn = lambda: (Wp @ head + bias).view(Qp, -1, 8).amax(-1)  # noqa: E731
        peak = PEAK_F32_FLOPS
    library_ms = time_ms(lib_fn, reps)
    n_bytes = (D * N * head.element_size() + Qp * D * head.element_size()
               + N * 4 + Qp * (N // 8) * 4)
    flops = 2.0 * Qp * D * N
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    bound_ms, bound_by = max((t_bytes, "bytes"), (t_ops, "operations"))
    say(f"[k2 fused_head] head {tuple(head.shape)} {head.dtype}, Qp={Qp}: "
        f"group maxima within rtol 1e-5 (max abs err {max_abs_err:.3e}), "
        f"final rows equal; kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} "
        f"library_ms={library_ms:.5f} bound_ms={bound_ms:.5f} ({bound_by}; "
        f"bytes {t_bytes:.5f} ms, operations {t_ops:.5f} ms)")
    return dict(name="fused_head", route="cuda",
                source="tdr_torch/csrc/fused_head.cu",
                replaces="tdr/ops/pallas_flat.py:284", launches=0,
                max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def check_fused_head_f32(index, qids, qw):
    """K2's f32-head variant (CUDA-core FMA) on an f32 copy of the same head:
    group maxima within rtol 1e-5 of the plain version."""
    import torch
    from tdr_torch.ops import fused_head as fh

    head = index.head_rows.float()
    D, N = head.shape
    Q = qids.shape[0]
    Qp = fh._round_up(Q, 128)
    W, _, _ = fh.query_weight_matrix(index, qids, qw)
    Wp = torch.zeros((Qp, D), dtype=torch.float32, device=head.device)
    Wp[:Q] = W
    bias = torch.where(torch.arange(N, device=head.device) < index.n_docs,
                       0.0, fh.NEG).float()
    kern = fh.fused_head_blockmax(Wp, head, bias)
    plain = fh.fused_head_blockmax_plain(Wp, head, bias)
    torch.cuda.synchronize()
    err = (kern - plain).abs()
    if not bool((err <= 1e-5 * plain.abs() + 1e-6).all()):
        fail(f"fused_head f32: group maxima differ beyond rtol 1e-5 "
             f"(max abs err {err.max().item():.3e})")
    ms = time_ms(lambda: fh.fused_head_blockmax(Wp, head, bias), 3, warmup=1)
    say(f"[k2 fused_head f32 head] {tuple(head.shape)}: group maxima within "
        f"rtol 1e-5 (max abs err {err[plain > fh.NEG / 2].max().item():.3e}); "
        f"kernel_ms={ms:.5f}")
    del head


def same_ranking(docs_a, scores_a, docs_b, scores_b, rtol=1e-5, atol=1e-4):
    """Equal top-k lists, except that docs whose scores are equal within
    the tolerance may swap places (the engines sum in different orders)."""
    import numpy as np

    if len(docs_a) != len(docs_b):
        return False
    if not np.allclose(scores_a, scores_b, rtol=rtol, atol=atol):
        return False
    for j, (a, b) in enumerate(zip(docs_a, docs_b)):
        if a != b and np.isclose(scores_b, scores_b[j], rtol=rtol,
                                 atol=atol).sum() < 2:
            return False
    return True


def reference_check(models, queries, langs):
    """Each language's first batch: fused path vs the scatter path."""
    import numpy as np
    import torch
    from tdr_torch.ops.score import score_and_topk
    from tdr_torch.text.fast import fast_tokenize_texts

    for lang, model in sorted(models.items()):
        sel = [i for i, l in enumerate(langs) if l == lang][:256]
        if not sel:
            continue
        toks = fast_tokenize_texts([queries[i] for i in sel], lang)
        qids, qw = model.encode_query_tokens(toks)
        fv, fr = model.topk_encoded_async(qids, qw, 10)
        sv, sr = score_and_topk(model.index, qids, qw, 10)
        fv, fr, sv, sr = (t.cpu().numpy() for t in (fv, fr, sv, sr))
        if fv.shape != (len(sel), 10) or not np.isfinite(fv[:, 0]).all():
            fail(f"reference {lang}: bad shape or non-finite top scores")
        # tail sums come from a cumsum difference: 1e-4 absolute covers
        # its cancellation at these score magnitudes
        if not np.allclose(fv, sv, rtol=1e-5, atol=1e-4):
            fail(f"reference {lang}: scores differ from the scatter path")
        diff = fr != sr
        for q in np.nonzero(diff.any(axis=1))[0]:
            if not same_ranking(fr[q], fv[q], sr[q], sv[q]):
                fail(f"reference {lang}: query {q} ranks differ")
        say(f"[reference {lang}] {len(sel)} queries: fused path == scatter "
            f"path ({int(diff.sum())} rank slots inside near-ties)")


def profile_pass(router, queries, trace_out) -> None:
    """One retrieve under torch.profiler: device time by kernel name, and
    the share of the pass's wall time the device was busy (union of kernel
    intervals).  With ``trace_out`` the Chrome trace is written there."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        router.retrieve(queries.queries, queries.langs, k=10)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type.name == "CUDA")
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    say(f"[profile] pass wall {wall * 1e3:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms ({100 * busy / 1e3 / (wall * 1e3):.1f}%), "
        f"{len(spans)} device events")
    rows = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = getattr(e, "cuda_time_total", 0)
        if t > 0 and e.device_type.name == "CUDA":
            rows[e.key] = (t, e.count)
    for key, (t, n) in sorted(rows.items(), key=lambda kv: -kv[1][0])[:15]:
        say(f"[profile]   {t / 1e3:10.3f} ms  x{n:<5d} {key[:90]}")
    if trace_out:
        os.makedirs(os.path.dirname(os.path.abspath(trace_out)), exist_ok=True)
        prof.export_chrome_trace(trace_out)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--queries", type=int, default=2000)
    ap.add_argument("--reps", type=int, default=5, help="timed passes")
    ap.add_argument("--profile", action="store_true",
                    help="trace one more pass with torch.profiler: device "
                         "time by kernel and the device's busy share")
    ap.add_argument("--trace-out", default=None,
                    help="with --profile: write the Chrome trace to this file")
    args = ap.parse_args()

    if not os.path.isdir(os.path.join(HERE, "tdr_torch")):
        fail("tdr_torch/ not found beside chip_smoke.py: run from a checkout")
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, HERE)
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- phase 1: the card, the kernels --------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    say(card)
    say(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    from tdr_torch.ops import cuda_build

    log = cuda_build.build(force=True)
    say(f"kernels built in {cuda_build.build_seconds:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            say("  " + line.strip())

    # -- phase 2: corpus + index build ---------------------------------------
    from tdr_torch.data import SyntheticSpec, synthetic_corpus
    from tdr_torch.eval import recall_at_k
    from tdr_torch.ops.fused_head import fused_head_available
    from tdr_torch.rank import LanguageRouter, build_language_models
    from tdr_torch.utils.config import IndexConfig

    t0 = time.perf_counter()
    corpus, queries = synthetic_corpus(SyntheticSpec(
        n_docs=N_DOCS, n_queries=args.queries, seed=42, hard=True))
    say(f"corpus: {N_DOCS} docs, {args.queries} queries in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    models = build_language_models(
        corpus, index_cfg=IndexConfig(head_budget_bytes=HEAD_BUDGET),
        device="cuda")
    say(f"index build: {time.perf_counter() - t0:.1f} s")
    for lang, m in sorted(models.items()):
        ix = m.index
        engine = ("fused" if fused_head_available(ix) else "matmul") + (
            "+tail_compact" if ix.head_size < ix.vocab_size else "")
        say(f"  {lang}: docs {ix.n_docs} (pad {ix.n_docs_pad}), vocab "
            f"{m.vocab.size} (pad {ix.vocab_size}), head_size {ix.head_size}, "
            f"tail_pmax {ix.tail_pmax}, engine {engine}")

    # -- phase 3: each kernel against its plain version ----------------------
    fused_langs = [l for l, m in models.items() if fused_head_available(m.index)]
    tail_langs = [l for l, m in models.items()
                  if m.index.head_size < m.index.vocab_size]
    if not fused_langs or not tail_langs:
        fail(f"main path misses a kernel: fused {fused_langs}, tail {tail_langs}")
    k2_lang = "en" if "en" in fused_langs else fused_langs[0]
    k1_lang = "es" if "es" in tail_langs else tail_langs[0]
    router = LanguageRouter(models, query_batch=256)

    def batch(lang, n):
        qs = [q for q, l in zip(queries.queries, queries.langs) if l == lang][:n]
        toks = router._tokenize(qs, range(len(qs)), lang)
        toks = toks + [[]] * (n - len(toks))
        return models[lang].encode_query_tokens(toks)

    qids, qw = batch(k2_lang, 256)
    rec_k2 = check_fused_head(models[k2_lang].index, qids, qw)
    check_fused_head_f32(models[k2_lang].index, qids, qw)
    qids, qw = batch(k1_lang, 256)
    rec_k1 = check_tail_compact(models[k1_lang].index, qids, qw, "Q=256")
    qids, qw = batch(k1_lang, 1)
    check_tail_compact(models[k1_lang].index, qids, qw, "Q=1")

    # -- phase 4: the main path ----------------------------------------------
    cuda_build.reset_launches()
    router.retrieve(queries.queries, queries.langs, k=10)
    torch.cuda.synchronize()
    counts = dict(cuda_build.launches)
    say(f"launches in one {args.queries}-query pass: {counts}")
    times = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        results = router.retrieve(queries.queries, queries.langs, k=10)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    recall = recall_at_k(results, queries.positive_docs, 10)
    say(f"retrieve: median {med:.4f} s of {[round(t, 4) for t in times]} for "
        f"{args.queries} queries -> {args.queries / med:.1f} queries/s, hard "
        f"recall@10 {recall:.4f} on {card}")
    if recall < RECALL_FLOOR:
        fail(f"recall@10 {recall:.4f} below the floor {RECALL_FLOOR}")
    if any(len(r) != 10 for r in results):
        fail("a query returned fewer than 10 docs")

    if args.profile:
        profile_pass(router, queries, args.trace_out)

    # -- phase 5: the small-batch buckets ------------------------------------
    full_docs, full_scores = router.retrieve_with_scores(
        queries.queries, queries.langs, k=10)
    sel = [0, 1, 2] + [i for i, l in enumerate(queries.langs) if l == k1_lang][:8]
    for group in ([0], [1], [2], sel[3:]):
        docs, scores = router.retrieve_with_scores(
            [queries.queries[i] for i in group],
            [queries.langs[i] for i in group], k=10)
        for j, i in enumerate(group):
            if not same_ranking(docs[j], scores[j], full_docs[i],
                                full_scores[i]):
                fail(f"query {i} in a batch of {len(group)} differs from "
                     f"the full batch")
    say(f"buckets: 3 single queries and a query of {len(sel) - 3} match the "
        f"full batches")

    # -- phase 6: reference check --------------------------------------------
    reference_check(models, queries.queries, queries.langs)

    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    rec_k1["launches"] = counts["tail_compact"]
    rec_k2["launches"] = counts["fused_head"]
    say(f"total {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": [rec_k1, rec_k2]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
