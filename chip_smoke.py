#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tdr_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                 # the full 268,022-doc run
    python3 chip_smoke.py --queries 500   # fewer queries, same corpus

Phases, in order (any failure exits non-zero and prints no result line):

1. the card's name and power limit; build the CUDA kernels from
   ``tdr_torch/csrc`` (one nvcc per source, in parallel);
2. the synthetic corpus (``hard=True``, ``seed=42``) and one BM25 index per
   language with a 4 GiB total head budget;
3. K1 and K2 against their plain torch versions on the card, at the shapes
   of the index just built, with times: kernel, plain, library yardstick,
   bound.  fused_head on en: the first batch of 256 queries, the last
   (partial) batch, a batch with no head term (n_active = 0) and a batch
   of 16 distinct slots per query covering every head row (n_active = D),
   and a head slice of 131,200 documents (the last tile half empty); the
   same on an f32 copy of the en head through K2's f32 body (3xTF32 on the
   tensor cores: bound at three TF32 products, and at the f32 peak);
   tail_compact (one launch from query terms to compacted rows) bit for
   bit against its plain version on es at Q=256 and Q=1, on every K1 call
   of one sparse pass as the router makes it (Q and the queries with a
   tail term printed), on a batch with an overflowed query of each kind
   and on one with no tail term; its device time (torch.profiler,
   ``kernel_ms``), call time (CUDA events over 50 calls, ``ms`` and
   ``call_ms``) and device kernels per call (exactly 1);
3b. K3 (fused_flat) against its plain version at the dense bench's shape
   (262,144 random unit embeddings, D=256, Q=256): {bf16, int8, f32} x
   {ip, l2} and one n_valid < N case; then 64 more rows (the last
   document tile ragged) in bf16 and int8, and D=768 bf16 (65,664 rows:
   too deep for the resident query slab, so the query tile streams);
3c. K4 (head_scores) against its plain version on the en and de heads at
   Q = 1, 8 and 256, with a query of more than 16 head terms; its launch
   count comes from one Q=256 call (no main path drives it);
3d. the encoder's LayerNorm kernels, forward and backward, against their
   plain versions (``layer_norm_plain``, ``layer_norm_backward_plain``) at
   the train path's shape (262,144 x 384 bf16, eps 1e-6) and at BERT's
   (65,536 x 768 f32, eps 1e-12), with constant rows, timed beside their
   bounds, the plain versions, the plain forward with autograd's backward,
   and ``F.layer_norm`` (a yardstick: the port never calls it); one train
   step at ``DenseConfig()`` width launches each 13 times;
3e. the encoder's attention kernels, forward and backward, against their
   plain versions (``attend_plain``, ``attend_backward_plain``) and an
   unrounded f32 reference at the train path's shape (2,048 x 12 heads x
   128 x 32 bf16) and at (64, 12, 512, 64), with padded rows and fully
   padded sequences, and at small ragged shapes; timed beside their
   bounds, the plain versions, the plain forward with autograd's backward,
   and ``F.scaled_dot_product_attention`` (a yardstick: the port never
   calls it); one train step launches each 6 times;
3f. the AdamW kernel (``ops.adamw.AdamW``) against torch's foreach path
   (``torch.optim.AdamW``) over 3 steps from one state, at MiniLM's
   ``DenseConfig()`` parameters and at one DeepSeek-V2-Lite MoE layer's,
   gaps in ulps, timed beside its bound (28 bytes a parameter), the
   foreach path and ``torch._fused_adamw_`` (a yardstick: the port never
   calls it); one launch a step; one train step launches it once, and
   three build its chunk table once;
4. the sparse main path: ``LanguageRouter.retrieve`` over all queries,
   launch counts set to 0 just before one pass and read just after, then
   timed passes; queries/s and hard recall@10;
5. single queries and a query of 8 (the small-batch buckets); 64 single
   es queries one at a time (median ms a query);
6. a reference check: each language's first batch through the fused path
   against the plain scatter path (full score matrix + stable top-k);
7. the dense path: ``DenseModel.build`` over the same corpus with the
   ``DenseConfig()`` encoder from ``init_encoder(seed=0)``, then
   ``DenseModel.retrieve`` over all queries (counts set to 0 just before
   one pass, read just after), timed passes (end to end and search only),
   recall@10 (untrained encoder: reported, no floor), K3 against its plain
   version at the pass's own shape, the fused engine against the plain one
   on the first 256 queries, and IVF (nlist 512, nprobe 16) on the bench
   embeddings;
8. the rest of the sparse path, on the phase-2 models: (a) PRF through the
   router (F=3, E=5) with and without spell repair — one-time doc-major
   build, K1/K2 launches of one pass, the second pass's overflowed share,
   timed passes, recall@10 held to the JAX recalls 0.769 and 0.7975
   (+-0.003), K1 on es's first PRF-expanded batch (T = 69) against its
   plain version, and the pass against the scatter path; (b) the exact_compact
   and approx modes against exact, with tier-2 trips; (c) the en model in
   a ``SegmentedBM25`` store: 100 added docs retrievable, a 768-query pass
   against the main model alone, 48 / 192 / 250 deleted top hits (K2 at
   top_k 74 / 266 / 1034) never returned, a store-level PRF pass; (d) es's
   own top-200 re-scored by ``score_candidates_fused`` (K1) and
   ``score_pairs`` within the bf16 head's bound; (e) the cosine -> BM25
   cascade on an en-only corpus of 207,363 docs (seed 7), held to the JAX
   recall 0.774 (+-0.003); (f) ``save_registry`` / ``load_registry`` of the
   seven models, the loaded router's results equal;
9. f32 operands through the f32 bodies of K2 and K3: (a) after phase 8,
   with the bf16 models freed, ``build_language_models`` at
   ``head_dtype="float32"`` under an 8 GiB head budget (the 4 GiB bf16
   build's slots; en a full-vocab f32 head), the 2000-query pass (K2 f32
   once per en batch, median of 5, recall@10 reported, no JAX number to
   hold it to) and its lists against the scatter path; (b) inside phase 7,
   an f32 copy of the dense index through K3's f32 body at the pass's
   shape (``check_fused_flat``, one ``flat_search`` pass, lists against
   the plain engine); (c) after (a), with TF32 turned on as a user would
   (``torch.set_float32_matmul_precision("high")``): K2 f32 at en Q=256,
   K3 f32 at the bench shape (ip, l2), the f32-head pass against (a)'s
   scatter lists and the f32 dense copy against the plain engine, at
   unchanged tolerances, the flag read back after each, a verdict for
   each check and one failure at the end, then restored.  The script sets
   no precision flag of its own;
10. the sentence-BM25 -> BERT re-rank cascade (bench.py:417-507), after
   9c: 100,000 en docs x 6 sentences (seed 7; 200 dev and 500 eval
   queries), ``SentenceBM25`` under a 1 GiB head budget, a
   ``BertEncoder`` at MiniLM-L12 width and f32 with seeded random weights
   in a ``DenseModel`` (32 tokens), ``SentenceLmCascade`` with 100
   candidates: the card's encoder within 1e-4 of the same module on the
   CPU (64 sentences), the embedding pass (seconds, share of the f32
   peak), ``tune_fusion_alpha`` on dev, a warm call, the eval pass with
   its stage-1 lists (counts set to 0 just before, read just after; K1
   must launch), 3 timed passes whose lists must equal it; stage-1
   recall@10 and candidate ceiling held to the JAX 0.696 and 0.924
   (+-0.003), alpha 1 without doc evidence equal to the stage-1 order;
11. dense-encoder training (bench.py:422-507), after 10, on its corpus:
   (a) the JAX bench's flow: a doc-level BM25 router over the 100,000 docs
   (default budget; en a full-vocab head, K2), 4000 pseudo-queries (seed
   11) and the 200 dev queries, 2 hard negatives each mined through the
   router (K2 launches counted), ``train_dense_retriever`` for 3 epochs of
   50 at ``DenseConfig(vocab_size=4000, dim=64, depth=2, heads=4,
   max_len=32)``, lr 1e-3, the trained encoder in the sentence cascade
   (K1 counted): loss falling, tuned alpha below 1, LM recall@10 above the
   stage-1 0.696, doc BM25 recall@10 held to the JAX 0.768 (+-0.003); the
   loss curve and the LM and RRF recalls reported beside the JAX ones;
   (b) the same trainer at ``DenseConfig()`` width (50,000 x 384, depth 6,
   12 heads, 128 tokens, bf16), one epoch on (a)'s queries: step time,
   tokens/s, model FLOP and their share of the bf16 peak, peak memory,
   the loss falling; the trained encoder's ``DenseModel`` over the 100,000
   docs (K3 counted) against the untrained one's recall; a train-state
   round trip (2 steps, save, load, 2 steps == 4 steps) and a dense-model
   one on the card; (c) one f32 train step at a small width with TF32 off
   and on (params within 1e-6) and on the CPU (the CPU test's tolerances);
   (d) ``tfidf_svd`` at rank 256 on a TF-IDF index of phase 2's ar docs,
   card against CPU from one start matrix (signs pinned), the logistic
   ranker and the unigram LM card against CPU.

12. the parallel serving layer (``tdr_torch.parallel``), run after phase 8
   while phase 2's models, phase 7's dense index and 8e's cascade are on
   the card, over ``make_mesh(data=4)`` of ``cuda:(i % device_count)`` (4
   shards share one card, or spread over several): (a) the seven
   languages as ``ShardedBM25Model``s (S = 4) from phase 2's index arrays
   (the COO read back from each CSR), vocab and head size, in one
   ``LanguageRouter(query_batch=256)``: one counted pass, median of 5
   after a warm pass, recall@10 held to 0.7650 and lists to phase 4-5's
   router but near-ties (K1 on every tail-bearing shard); (b)
   ``grid_score_topk`` on en over 2 x 2 and ``dp_score_topk`` on es split
   4 ways against the single-device ``score_and_topk`` (one 256-query
   batch); (c) vocab TP: en's full-vocab head slot-sharded 4 ways, es as
   the hybrid (K1) on its bf16 and an int8 head and a batch over the tail
   budget (``exact_tail``), each against the single-device fused engine,
   ``per_device_bytes`` equal to ``vocab_shard_layout``'s; (d) phase 7's
   dense index over 4 shards against ``flat_search`` (K3) on the 2000
   encoded queries, l2 bf16 and int8 ip at the bench shape, and
   ``sharded_flat_search_prf`` against ``flat_search_prf``; (e)
   ``PipelinedCascade`` on 8e's models (stage 1 on mesh device 0, stage 2
   on mesh device 1): lists equal ``CascadeRetriever``'s, recall@10 0.774;
   (f) ``save_sharded_index`` / ``load_sharded_index`` of (a)'s en index,
   the loaded lists and scores equal.
13. the CLI (``tdr_torch.cli``), the sharded train step and real text:
   (a) after phase 12, phase 2's corpus and queries written as ``synth``
   writes them, then ``build`` (4 GiB head budget, bf16 heads), ``eval``
   (recall@10 held to 0.765; K1 and K2 launches counted), ``retrieve``
   (rows equal to phase 4's lists but for near-ties) and ``validate``, all
   through ``tdr_torch.cli.main`` in this process; (b) ``serve`` on (a)'s
   registry as a subprocess (every read with a timeout): 64 single
   requests over the seven languages, a burst of 256, a malformed line
   and a request with no ``lang``, answers held to the in-process router;
   then ``serve --mutable``: an added doc found, a deleted one gone; (c)
   phase 7's dense model saved with ``save_dense_model`` and retrieved by
   ``retrieve-dense`` (one K3 launch, ``DenseModel.retrieve``'s lists);
   (d) after 11b, the sharded train step at ``DenseConfig()`` width on a
   data 2 x model 2 mesh over ``cuda:(i % device_count)``, 20 steps of
   11b's batches from one init against the single-device step (losses
   within rtol 1e-2, params' 99th percentile within lr, data replicas
   bit-equal, per-device bytes equal to ``train_state_layout``, a sharded
   checkpoint round trip equal to straight training), then ``train --mesh
   2x2`` through the CLI (unsharded on one card: a mesh needs more than
   one visible device); (e) last, ``real_eval_corpus`` through the build
   and the router on the card at the "best" and "porter" pipelines, lists
   equal to the CPU's, "best" recall@10 >= 0.95 and recall@1 >= 0.90;
   (f) after (c), ``tdr``'s public helpers on the card: ``segment_df``,
   ``compute_idf`` and ``select_head`` from en's and es's COO bit for bit
   against phase 2's statistics (and ``select_head`` against a host
   lexsort in ``lax.top_k``'s order), ``nnz`` and ``memory_bytes()`` of
   the seven models against their tensors' storages, each of ``tdr``'s
   ``tail_engine`` values one K1 launch with the default call's lists, and
   ``flat_search(recall_target=0.5)`` one K3 launch.

Each kernel must have launched in the pass that drives it.
The second-to-last line is the ``{"kernels": [...]}`` JSON (K1, K2, K2 f32,
K3, K3 f32, K4, the LayerNorm's forward and backward); the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or ``tdr``.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12            # dense bf16 tensor cores
PEAK_F32_FLOPS = 67e12              # f32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12            # dense tf32 tensor cores
PEAK_INT8_OPS = 1979e12             # dense int8 tensor cores
RECALL_FLOOR = 0.75
N_DOCS = 268_022                    # the full corpus: never cut
HEAD_BUDGET = 1 << 32               # 4 GiB of dense head, all languages
DEVICE = "cuda"                     # every tensor of the run lives on the card


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


def k1_budget(index, tail_budget=2048):
    """The budget the sparse path gives K1 (``score._fused_topk_core``)."""
    return min(max(tail_budget, 4 * index.tail_pmax), 16 * index.tail_pmax)


def tail_queries(index, qids, qw):
    """How many queries of a batch hold a tail term (slot < 0, weight > 0)."""
    slot = index.head_slot[qids.clamp(0, index.vocab_size - 1).long()]
    return int(((slot < 0) & (qw > 0)).any(dim=1).sum().item())


def check_tail_compact(index, qids, qw, label, budget=None):
    """K1 (one launch: term compaction, offset scan, segment copy, overflow)
    against its plain version (``tail_segments`` + ``tail_compact_rows_plain``)
    on the same batch: rows bit for bit and overflow equal.  Returns (Q,
    queries with a tail term, overflowed queries)."""
    import torch
    from tdr_torch.ops import tail_compact as tc

    budget = k1_budget(index) if budget is None else budget
    kd, kv, ko = tc.tail_compact(index, qids, qw, budget)
    pd, pv, po = tc.tail_compact_plain(index, qids, qw, budget)
    torch.cuda.synchronize()
    if not (torch.equal(kd, pd) and torch.equal(kv.view(torch.int32),
                                                pv.view(torch.int32))):
        fail(f"tail_compact {label}: kernel rows differ from the plain version")
    if not torch.equal(ko, po):
        fail(f"tail_compact {label}: overflow flags differ from the plain "
             f"version")
    Q, T = qids.shape
    n_tail, n_over = tail_queries(index, qids, qw), int(ko.sum().item())
    say(f"[k1 tail_compact {label}] Q={Q} T={T} budget={budget} "
        f"W={kd.shape[1]}: {n_tail} queries with a tail term, {n_over} "
        f"overflowed; rows bit-exact, overflow equal")
    return Q, n_tail, n_over


def k1_device_times(index, qids, qw, budget, reps=50, one_launch=True):
    """One ``tail_compact`` call as the path makes it: its device kernels
    per call and the mean device time of its ``tail_compact`` kernel
    (torch.profiler over ``reps`` calls), and ``call_ms`` (CUDA events
    around ``reps`` back-to-back calls: the call's rate, host included).
    With ``one_launch``, fails unless the call is exactly one device
    kernel.  Returns (kernel_ms, call_ms, device kernels per call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from tdr_torch.ops import tail_compact as tc

    call = lambda: tc.tail_compact(index, qids, qw, budget)  # noqa: E731
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    # the profiler has been seen to drop one kernel event of 50 (0.98
    # kernels a call, all of them tail_compact): a trace with fewer events
    # than calls and no other kernel is taken again, up to three times
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type.name == "CUDA"]
        mine = [e.time_range.end - e.time_range.start for e in dev
                if "tail_compact" in e.name]
        if not (one_launch and len(dev) < reps and len(mine) == len(dev)):
            break
    if not mine:
        fail("tail_compact: the profiler saw no tail_compact kernel")
    per_call = len(dev) / reps
    if one_launch and per_call != 1:
        names = sorted({e.name[:60] for e in dev})
        fail(f"tail_compact: one call ran {per_call} device kernels, not 1: "
             f"{names}")
    kernel_ms = sum(mine) / len(mine) / 1e3
    call_ms = time_ms(call, reps)
    return kernel_ms, call_ms, per_call


def k1_record(index, qids, qw, label, reps=50):
    """K1's record at one batch: kernel and call times, plain time, bound."""
    import torch
    from tdr_torch.ops import tail_compact as tc

    budget = k1_budget(index)
    kernel_ms, call_ms, per_call = k1_device_times(index, qids, qw, budget,
                                                   reps)
    plain_ms = time_ms(lambda: tc.tail_compact_plain(index, qids, qw, budget),
                       reps)
    Q, T = qids.shape
    starts, lens, _, _, _ = tc.tail_segments(index, qids, qw, budget)
    width = tc.row_width(budget, index.tail_pmax)
    seg = int(lens.sum().item())
    # outputs, segment entries, the four (Q, MT) term tables, qids and qw
    n_bytes = (Q * width * 8 + Q + seg * 8 + 4 * 4 * starts.numel()
               + Q * T * 8)
    bound_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    say(f"[k1 tail_compact {label}] Q={Q} T={T} W={width} segment "
        f"entries={seg}: {per_call:.0f} device kernel a call; "
        f"kernel_ms={kernel_ms:.5f} (device, torch.profiler) call_ms="
        f"{call_ms:.5f} plain_ms={plain_ms:.5f} library_ms=null "
        f"bound_ms={bound_ms:.6f} (bytes; {100 * bound_ms / kernel_ms:.1f}% "
        f"of it in the kernel)")
    torch.cuda.synchronize()
    return dict(name="tail_compact", route="cuda",
                source="tdr_torch/csrc/tail_compact.cu",
                replaces="tdr/ops/pallas_tail.py:152", launches=0,
                max_abs_err=0.0, ms=call_ms, kernel_ms=kernel_ms,
                call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes", library_ms=None)


def k1_cases(models, router, queries, k1_lang, batch):
    """Phase 3's K1 cases: es at Q = 256 and Q = 1; every K1 call of one
    sparse pass as the router makes it (printed: Q and the queries with a
    tail term); a batch with an overflowed query of each kind; a batch with
    no tail term.  Each against the plain version, bit for bit.  Returns
    the record (es Q = 256)."""
    import torch
    from tdr_torch.ops import score

    index = models[k1_lang].index
    qids, qw = batch(k1_lang, 256)
    check_tail_compact(index, qids, qw, f"{k1_lang} Q=256")
    rec = k1_record(index, qids, qw, f"{k1_lang} Q=256")
    q1 = batch(k1_lang, 1)
    check_tail_compact(index, *q1, f"{k1_lang} Q=1")
    k1_record(index, *q1, f"{k1_lang} Q=1")

    # the pass's own K1 calls, recorded as the router makes them
    calls, real = [], score.tail_compact

    def record(ix, qids, qw, budget, *a):
        calls.append((ix, qids, qw, budget))
        return real(ix, qids, qw, budget, *a)

    score.tail_compact = record
    try:
        router.retrieve(queries.queries, queries.langs, k=10)
    finally:
        score.tail_compact = real
    langs = {id(m.index): l for l, m in models.items()}
    for i, (ix, qids, qw, budget) in enumerate(calls):
        check_tail_compact(ix, qids, qw, f"pass call {i} "
                           f"({langs.get(id(ix), '?')})", budget)

    # overflow of each kind, at the path's smallest budget (4 tail_pmax):
    # row 0 has 20 tail terms, row 1 the 16 longest (clamped offsets overlap)
    P = index.tail_pmax
    df = index.stats.df
    tail = torch.nonzero((index.head_slot < 0) & (df > 0))[:, 0]
    longest = tail[torch.argsort(df[tail], descending=True, stable=True)]
    qids, qw = (t.clone() for t in batch(k1_lang, 256))
    if qids.shape[1] < 20:
        pad = 20 - qids.shape[1]
        qids = torch.nn.functional.pad(qids, (0, pad))
        qw = torch.nn.functional.pad(qw, (0, pad))
    qids[:2], qw[:2] = 0, 0.0
    qids[0, :20] = tail[:20].to(qids.dtype)
    qw[0, :20] = 1.0
    qids[1, :16] = longest[:16].to(qids.dtype)
    qw[1, :16] = 2.0
    _, _, n_over = check_tail_compact(index, qids, qw, "overflow rows",
                                      budget=4 * P)
    if n_over < 2:
        fail(f"tail_compact overflow rows: {n_over} overflowed, 2 expected")
    qids, qw = batch(k1_lang, 256)
    slot = index.head_slot[qids.clamp(0, index.vocab_size - 1).long()]
    _, n_tail, _ = check_tail_compact(index, qids,
                                      torch.where(slot < 0, 0.0, qw),
                                      "no tail term")
    if n_tail:
        fail("tail_compact no-tail batch: a tail term is left")
    return rec


def k2_operands(index, qids, qw, Qp):
    """K2's operands for one batch: (rows, n_active, Wc) from the batch's
    active terms, through the path's own functions."""
    from tdr_torch.ops import fused_head as fh

    W, slot, active = fh.query_weight_matrix(index, qids, qw)
    return fh.compact_active_rows(W, slot, active, Qp, index.head_rows.dtype)


def cover_batch(index, n=256):
    """(index', qids, qw): a batch of n queries of 16 head terms each, query
    q taking the terms of slots 16q .. 16q + 15 (mod D), so together they
    use every head row (n_active = D).  A full-vocab head leaves the slots
    of terms that no document holds unmapped; index' is the index with its
    unmapped terms given those slots in order (their head rows are zero),
    so every slot has a term."""
    import torch

    hs = index.head_slot.clone()
    D = index.head_rows.shape[0]
    free_terms = torch.nonzero(hs < 0)[:, 0]
    taken = torch.zeros(D, dtype=torch.bool, device=hs.device)
    taken[hs[hs >= 0].long()] = True
    free_slots = torch.nonzero(~taken)[:, 0]
    k = min(free_terms.numel(), free_slots.numel())
    hs[free_terms[:k]] = free_slots[:k].to(hs.dtype)
    index = dataclasses.replace(index, head_slot=hs)
    term_of = torch.full((D,), -1, dtype=torch.long, device=hs.device)
    mapped = torch.nonzero(hs >= 0)[:, 0]
    term_of[hs[mapped].long()] = mapped
    slots = (torch.arange(n * 16, device=hs.device) % D).view(n, 16)
    terms = term_of[slots]
    qids = terms.clamp(min=0).to(torch.int32)
    qw = (terms >= 0).float() * ((slots % 5) + 1).float() / 2
    return index, qids, qw


def check_fused_head(index, qids, qw, label, want_active=None, reps=10):
    """K2 against its plain version at one batch: group maxima within rtol
    1e-5 and the final (vals, rows) of ``fused_head_topk`` equal; fails
    unless n_active is ``want_active`` where that is given.  Returns its
    record; ``bound_ms`` is the active-row bound (each distinct row read
    once), the whole-head bound is printed beside it.  An f32 head runs the
    3xTF32 body: its record is ``fused_head_f32``, ``bound_ms`` counts its
    three TF32 products at the tensor cores' TF32 rate and
    ``f32_bound_ms`` one product at the f32 peak."""
    import torch
    from tdr_torch.ops import fused_head as fh

    head = index.head_rows
    D, N = head.shape
    Q = qids.shape[0]
    Qp = fh._round_up(Q, 128)
    rows, n_active, Wc = k2_operands(index, qids, qw, Qp)
    n_act = int(n_active.item())
    if want_active is not None and n_act != want_active:
        fail(f"fused_head {label}: n_active {n_act}, expected {want_active}")
    bias = torch.where(torch.arange(N, device=head.device) < index.n_docs,
                       0.0, fh.NEG).float()
    args = (Wc, head, rows, n_active, bias)
    kern = fh.fused_head_blockmax(*args)
    plain = fh.fused_head_blockmax_plain(*args)
    torch.cuda.synchronize()
    err = (kern - plain).abs()
    tol = 1e-5 * plain.abs() + 1e-6
    if not bool((err <= tol).all()):
        fail(f"fused_head {label}: group maxima differ beyond rtol 1e-5 "
             f"(max abs err {err.max().item():.3e})")
    max_abs_err = float(err[plain > fh.NEG / 2].max().item())
    kv, kr = fh.fused_head_topk(index, qids, qw, top_k=10)
    pv, pr = fh.fused_head_topk(index, qids, qw, top_k=10,
                                blockmax=fh.fused_head_blockmax_plain)
    if not torch.equal(kr, pr) or not torch.equal(kv, pv):
        fail(f"fused_head {label}: final (vals, rows) differ between kernel "
             f"and plain")
    ms = time_ms(lambda: fh.fused_head_blockmax(*args), reps)
    plain_ms = time_ms(lambda: fh.fused_head_blockmax_plain(*args), 3,
                       warmup=1)
    # the library yardstick: the whole-head product of the uncompacted W
    Wp = torch.zeros_like(Wc)
    Wp[:, rows.long()] = Wc
    f32 = head.dtype == torch.float32
    if f32:
        lib_fn = lambda: (Wp @ head + bias).view(Qp, -1, 8).amax(-1)  # noqa: E731
        peak, products = PEAK_TF32_FLOPS, 3
    else:
        lib_fn = lambda: (torch.mm(Wp, head, out_dtype=torch.float32)  # noqa: E731
                          + bias).view(Qp, -1, 8).amax(-1)
        peak, products = PEAK_BF16_FLOPS, 1
    library_ms = time_ms(lib_fn, reps)
    es = head.element_size()
    io = N * 4 + Q * (N // 8) * 4                 # bias in, group maxima out

    def bound(d, peak=peak, products=products):
        t_b = (d * N * es + Q * d * es + d * 4 + io) / PEAK_BYTES_PER_S * 1e3
        t_o = products * 2.0 * Q * d * N / peak * 1e3
        return max((t_b, "bytes"), (t_o, "operations"))

    bound_ms, bound_by = bound(n_act)
    whole_ms, whole_by = bound(D)
    rec = dict(name="fused_head_f32" if f32 else "fused_head", route="cuda",
               source="tdr_torch/csrc/fused_head.cu",
               replaces="tdr/ops/pallas_flat.py:284", launches=0,
               max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    kind = "3xTF32, " if f32 else ""
    extra = ""
    if f32:
        rec["f32_bound_ms"] = bound(n_act, PEAK_F32_FLOPS, 1)[0]
        extra = (f" f32_peak_bound_ms={rec['f32_bound_ms']:.5f} (whole head "
                 f"{bound(D, PEAK_F32_FLOPS, 1)[0]:.5f})")
    say(f"[k2 fused_head {label}] head {tuple(head.shape)} {head.dtype}, "
        f"Q={Q} (Qp={Qp}), n_active={n_act} of {D} rows: group maxima "
        f"within rtol 1e-5 (max abs err {max_abs_err:.3e}), final rows "
        f"equal; kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} "
        f"library_ms={library_ms:.5f} bound_ms={bound_ms:.5f} ({kind}"
        f"{bound_by}, active rows) whole_head_bound_ms={whole_ms:.5f} "
        f"({whole_by}){extra}")
    return rec


def check_fused_head_f32(index, cases):
    """K2's f32 body (3xTF32 on the tensor cores) on an f32 copy of the
    same head, through ``check_fused_head`` at each of ``cases`` ((qids,
    qw, label, want_active), the first the record's), then at full
    coverage and on the ragged slice: group maxima and final rows against
    the plain version, kernel, plain and library (``torch.mm`` f32 + group
    max) times and both bounds.  Returns the first case's record."""
    f32 = dataclasses.replace(index, head_rows=index.head_rows.float())
    recs = [check_fused_head(f32, qids, qw, f"f32 {label}", want_active=want,
                             reps=5)
            for qids, qw, label, want in cases]
    cover_ix, cover_qids, cover_qw = cover_batch(f32)
    check_fused_head(cover_ix, cover_qids, cover_qw, "f32 full coverage",
                     want_active=f32.head_rows.shape[0], reps=3)
    del cover_ix
    check_fused_head_ragged(f32, *cases[0][:2])
    del f32
    return recs[0]


def check_fused_head_ragged(index, qids, qw, n_docs=131_200):
    """K2 on a head slice whose document count is a multiple of 128 but not
    of the kernel's 256-document tile (the last tile half empty): group
    maxima within rtol 1e-5 of the plain version."""
    import torch
    from tdr_torch.ops import fused_head as fh

    head = index.head_rows[:, :n_docs].contiguous()
    Qp = fh._round_up(qids.shape[0], 128)
    rows, n_active, Wc = k2_operands(index, qids, qw, Qp)
    bias = torch.zeros(n_docs, device=head.device)
    kern = fh.fused_head_blockmax(Wc, head, rows, n_active, bias)
    plain = fh.fused_head_blockmax_plain(Wc, head, rows, n_active, bias)
    torch.cuda.synchronize()
    err = (kern - plain).abs()
    if not bool((err <= 1e-5 * plain.abs() + 1e-6).all()):
        fail(f"fused_head ragged N={n_docs}: group maxima differ beyond rtol "
             f"1e-5 (max abs err {err.max().item():.3e})")
    say(f"[k2 fused_head ragged] head {tuple(head.shape)} {head.dtype} "
        f"(N % 256 = "
        f"{n_docs % 256}), Q={qids.shape[0]}, n_active={int(n_active.item())}"
        f": group maxima within rtol 1e-5 (max abs err "
        f"{err.max().item():.3e})")
    del head


def same_ranking(docs_a, scores_a, docs_b, scores_b, rtol=1e-5, atol=1e-4):
    """Equal top-k lists, except that docs whose scores are equal within
    the tolerance may swap places (the engines sum in different orders).
    The reference ``b`` may run deeper than ``a``, so that a swap at the
    last rank can see its partner."""
    import numpy as np

    k = len(docs_a)
    if len(docs_b) < k or len(scores_b) < k:
        return False
    if not np.allclose(scores_a, scores_b[:k], rtol=rtol, atol=atol):
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


def bench_embeddings():
    """The dense bench's data (``bench.py:800-807``): 262,144 random unit
    embeddings of width 256 and 256 random queries, from numpy seeds."""
    import numpy as np

    emb = np.random.RandomState(0).randn(262_144, 256).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = np.random.RandomState(7).randn(256, 256).astype(np.float32)
    return emb, q


def flat_index_on_card(emb, metric, dtype):
    """A flat index of the port on the card; f32 storage (which the builder
    does not offer) gets the builder's padding and ‖d‖² as well."""
    import torch
    from tdr_torch.models.dense import FlatIndex, build_flat_index

    if dtype != "float32":
        return build_flat_index(emb, metric=metric, dtype=dtype, device=DEVICE)
    b = build_flat_index(emb, metric=metric, device=DEVICE)
    e = torch.zeros(b.embeddings.shape, dtype=torch.float32, device=DEVICE)
    e[:emb.shape[0]] = torch.as_tensor(emb, device=DEVICE)
    return FlatIndex(embeddings=e, doc_sq=b.doc_sq, n_docs=b.n_docs,
                     metric=metric)


def check_fused_flat(index, q, label, n_valid=None, reps=20):
    """K3 against its plain version at one batch: group maxima within rtol
    1e-5 (atol 1e-5: scores near 0 sum in another order), and the final
    (vals, rows) of ``fused_flat_topk`` equal to the plain engine's
    (product + top-k) except swaps inside near-ties.  Returns its record;
    f32 embeddings run the 3xTF32 body: ``fused_flat_f32``, with
    ``bound_ms`` at three TF32 products and ``f32_bound_ms`` at the f32
    peak."""
    import torch
    from tdr_torch.models.dense import flat_search
    from tdr_torch.ops import fused_flat as ff

    emb = index.embeddings
    N, D = emb.shape
    Q = q.shape[0]
    args, _, bias = ff.fused_flat_inputs(emb, q, index.metric, index.n_docs,
                                         index.doc_sq, index.doc_scale,
                                         n_valid)
    Qp, alpha = args[0].shape[0], args[3]
    kern = ff.fused_flat_blockmax(*args)
    plain = ff.fused_flat_blockmax_plain(*args)
    torch.cuda.synchronize()
    err = (kern - plain).abs()
    if not bool((err <= 1e-5 * plain.abs() + 1e-5).all()):
        fail(f"fused_flat {label}: group maxima differ beyond rtol 1e-5 "
             f"(max abs err {err.max().item():.3e})")
    max_abs_err = float(err[plain > ff.NEG / 2].max().item())
    kv, kr = ff.fused_flat_topk(emb, q, top_k=10, metric=index.metric,
                                n_docs=index.n_docs, doc_sq=index.doc_sq,
                                doc_scale=index.doc_scale, n_valid=n_valid)
    # n_valid overrides n_docs, so the plain engine sees n_docs = n_valid;
    # it runs 20 deep, so that a swap at rank 10 can see its partner
    plain_ix = (index if n_valid is None
                else dataclasses.replace(index, n_docs=n_valid))
    pv, pr = flat_search(plain_ix, q, 20, engine="plain")
    kv, kr, pv, pr = (t.cpu().numpy() for t in (kv, kr, pv, pr))
    for i in range(Q):
        if not same_ranking(kr[i], kv[i], pr[i], pv[i], rtol=1e-5, atol=1e-5):
            fail(f"fused_flat {label}: query {i} ranks differ from the plain "
                 f"engine")
    if n_valid is not None and (kr >= n_valid).any():
        fail(f"fused_flat {label}: a row past n_valid={n_valid} surfaced")
    ms = time_ms(lambda: ff.fused_flat_blockmax(*args), reps)
    plain_ms = time_ms(lambda: ff.fused_flat_blockmax_plain(*args), 3,
                       warmup=1)
    if emb.dtype == torch.int8:
        q8, _, _, _, dscale, qscale = args
        lib_fn = lambda: (alpha * (torch._int_mm(q8, emb.T).float()  # noqa: E731
                                   * dscale * qscale[:, None])
                          + bias).view(Qp, -1, 8).amax(-1)
        peak = PEAK_INT8_OPS
    elif emb.dtype == torch.bfloat16:
        lib_fn = lambda: (alpha * torch.mm(args[0], emb.T,  # noqa: E731
                                           out_dtype=torch.float32)
                          + bias).view(Qp, -1, 8).amax(-1)
        peak = PEAK_BF16_FLOPS
    else:
        lib_fn = lambda: (alpha * (args[0] @ emb.T)  # noqa: E731
                          + bias).view(Qp, -1, 8).amax(-1)
        peak = PEAK_TF32_FLOPS / 3          # three TF32 products
    library_ms = time_ms(lib_fn, reps)
    # the function's work is Q queries; the pad rows up to Qp are not
    esize = emb.element_size()
    n_bytes = (N * D * esize + Q * D * esize + N * 4 + Q * (N // 8) * 4
               + (N * 4 + Q * 4 if emb.dtype == torch.int8 else 0))
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 2.0 * Q * D * N / peak * 1e3
    bound_ms, bound_by = max((t_bytes, "bytes"), (t_ops, "operations"))
    f32 = emb.dtype == torch.float32
    rec = dict(name="fused_flat_f32" if f32 else "fused_flat", route="cuda",
               source="tdr_torch/csrc/fused_flat.cu",
               replaces="tdr/ops/pallas_flat.py:123", launches=0,
               max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    extra = ""
    if f32:
        rec["f32_bound_ms"] = max(t_bytes,
                                  2.0 * Q * D * N / PEAK_F32_FLOPS * 1e3)
        extra = (f"; 3xTF32 bound; f32_peak_bound_ms="
                 f"{rec['f32_bound_ms']:.5f}")
    say(f"[k3 fused_flat {label}] emb {tuple(emb.shape)} {emb.dtype}, "
        f"metric {index.metric}, Q={Q} (Qp={Qp}): group maxima within rtol "
        f"1e-5 (max abs err {max_abs_err:.3e}), final rows equal but for "
        f"near-ties; kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} "
        f"library_ms={library_ms:.5f} bound_ms={bound_ms:.5f} ({bound_by}; "
        f"bytes {t_bytes:.5f} ms, operations {t_ops:.5f} ms{extra})")
    return rec


def overflow_batch(index, qids, qw):
    """Row 0 becomes a query of 20 active head terms (over the cap of 16)."""
    import torch

    heads = torch.nonzero(index.head_slot >= 0)[:20, 0].to(qids.dtype)
    qids, qw = qids.clone(), qw.clone()
    qids[0] = 0
    qw[0] = 0.0
    qids[0, :heads.numel()] = heads
    qw[0, :heads.numel()] = 1.0
    return qids, qw


def check_head_scores(index, qids, qw, label, reps=10):
    """K4 against its plain version at one batch (bit for bit), and the
    whole entry point against the capped row gather (rows under the cap,
    rtol 1e-5) and the full-head product (tests/test_pallas.py's bounds).
    Returns its record."""
    import torch
    from tdr_torch.ops import head_scores as hs
    from tdr_torch.ops.score import _head_scores_capped, _head_scores_matmul

    rows = index.head_rows
    D, N = rows.shape
    Q, T = qids.shape
    slots, w, n_active = hs._prep_terms(index, qids, qw)
    TH = min(hs.DEFAULT_MAX_HEAD_TERMS, T)
    args = (rows, slots[:, :TH].contiguous(), w[:, :TH].contiguous(),
            n_active)
    kern = hs.head_scores_rows(*args)
    plain = hs.head_scores_rows_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(kern.view(torch.int32), plain.view(torch.int32)):
        fail(f"head_scores {label}: kernel differs from its plain version "
             f"(max abs err {(kern - plain).abs().max().item():.3e})")
    qc = qids.clamp(0, index.vocab_size - 1)
    full = hs.head_scores(index, qids, qw)
    over = n_active > TH
    for s in range(0, Q, 32):
        capped, _ = _head_scores_capped(index, qc[s:s + 32], qw[s:s + 32], TH)
        keep = ~over[s:s + 32]
        if not torch.allclose(full[s:s + 32][keep], capped[keep], rtol=1e-5,
                              atol=1e-6):
            fail(f"head_scores {label}: differs from the capped gather")
    ref = _head_scores_matmul(index, qc, qw)
    tol = (dict(rtol=2e-2, atol=1e-2) if rows.dtype == torch.bfloat16
           else dict(rtol=1e-4, atol=1e-5))
    if not torch.allclose(full, ref, **tol):
        fail(f"head_scores {label}: differs from the full-head product")
    ms = time_ms(lambda: hs.head_scores_rows(*args), reps)
    plain_ms = time_ms(lambda: hs.head_scores_rows_plain(*args), 3, warmup=1)
    library_ms = time_ms(lambda: _head_scores_matmul(index, qc, qw), reps)
    live = torch.arange(TH, device=rows.device)[None, :] < n_active[:, None]
    terms = int(live.sum().item())
    # each distinct head row is read once, however many queries share it
    distinct = int(torch.unique(args[1][live]).numel())
    n_bytes = (distinct * N * rows.element_size() + Q * N * 4
               + Q * TH * 8 + Q * 4)
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 2.0 * terms * N / PEAK_F32_FLOPS * 1e3
    bound_ms, bound_by = max((t_bytes, "bytes"), (t_ops, "operations"))
    say(f"[k4 head_scores {label}] head {tuple(rows.shape)} {rows.dtype}, "
        f"Q={Q}, {terms} active terms under the cap ({distinct} distinct "
        f"rows), {int(over.sum())} "
        f"overflowed: bit-exact, capped gather within rtol 1e-5, full "
        f"product within {tol}; kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} "
        f"library_ms={library_ms:.5f} bound_ms={bound_ms:.5f} ({bound_by})")
    return dict(name="head_scores", route="cuda",
                source="tdr_torch/csrc/head_scores.cu",
                replaces="tdr/ops/pallas_score.py:110", launches=0,
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def _ln_scale(t):
    return float(t.abs().max())


def check_layer_norm(x, eps, label, reps=20, seed=0):
    """The LayerNorm kernels (``tdr_torch/csrc/layer_norm.cu``) on ``x``
    (rows, D) against the plain versions on the card, then timed beside
    their bounds.  Returns the forward's and the backward's records.

    Tolerances, from f32 sums taken in another order (each kernel's sums
    run per lane in sequence, then a butterfly over the lanes; torch's
    reductions run in a tree), never from a precision of their own:

    * y: the mean and E[x²] each within a few ulps of a sum of D terms,
      moved by x-hat (|x-hat| < sqrt(D)): 1e-5 of the largest |y|, plus
      1e-5 relative;
    * dx: the two row sums of the closed form likewise, times rstd:
      1e-5 of the largest |dx|; dx in bf16 may also round one bf16 step
      (2^-8 relative) the other way from a value next to a rounding point,
      so bf16 adds 2^-7 relative;
    * dweight, dbias: sums over all the rows (the kernel: a lane's rows in
      sequence, its block's groups, then the blocks), within 256 ulps of
      the column's sum of absolute terms, the worst case of sums of these
      lengths;
    * constant rows: the kernel's y is the bias, bit for bit (its sums of
      equal short values are exact, so x - mean and E[x²] - mean² are 0);
      torch's mean multiplies by a rounded 1/D, so the plain version's is
      not.
    """
    import torch
    from tdr_torch.ops import layer_norm as lnk
    from tdr_torch.ops.layer_norm import (layer_norm_backward_plain,
                                          layer_norm_plain)

    rows, D = x.shape
    gen = torch.Generator(device=x.device).manual_seed(seed)
    w = 1.0 + 0.5 * torch.randn(D, generator=gen, device=x.device)
    b = 0.2 * torch.randn(D, generator=gen, device=x.device)
    dy = torch.randn(rows, D, generator=gen, device=x.device)
    y, stats = lnk.layer_norm_fwd(x, w, b, eps)
    dx, dw, db = lnk.layer_norm_bwd(dy, x, w, stats)
    y_p = layer_norm_plain(x, w, b, eps)
    dx_p, dw_p, db_p = layer_norm_backward_plain(dy, x, w, eps)
    torch.cuda.synchronize()
    if y.dtype != torch.float32 or dx.dtype != x.dtype:
        fail(f"layer_norm {label}: y {y.dtype}, dx {dx.dtype}")
    err_y = (y - y_p).abs()
    tol_y = 1e-5 * _ln_scale(y_p) + 1e-5 * y_p.abs()
    need(bool((err_y <= tol_y).all()),
         f"layer_norm {label}: forward off by {_ln_scale(err_y):.3e}")
    err_dx = (dx.float() - dx_p.float()).abs()
    rel = 2.0 ** -7 if x.dtype == torch.bfloat16 else 0.0
    tol_dx = 1e-5 * _ln_scale(dx_p.float()) + rel * dx_p.float().abs()
    need(bool((err_dx <= tol_dx).all()),
         f"layer_norm {label}: dx off by {_ln_scale(err_dx):.3e}")
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    raw = (xf * xf).mean(-1, keepdim=True) - mu * mu
    xh = (xf - mu) * torch.rsqrt(raw.clamp_min(0.0) + eps)
    for name, got, want, terms in (("dweight", dw, dw_p, dy * xh),
                                   ("dbias", db, db_p, dy)):
        bound = 256 * 2.0 ** -24 * terms.abs().sum(0)
        need(bool(((got - want).abs() <= bound).all()),
             f"layer_norm {label}: {name} off by "
             f"{_ln_scale(got - want):.3e}")
    # constant rows, and the statistics of the random ones
    const = (torch.arange(64, device=x.device, dtype=torch.float32)[:, None]
             / 8 - 3).expand(64, D).to(x.dtype).contiguous()
    yc, sc = lnk.layer_norm_fwd(const, w, b, eps)
    need(torch.equal(yc, b.expand(64, D)) and bool((sc[:, 1] > 0).all()),
         f"layer_norm {label}: constant rows are not the bias")
    err_mu = _ln_scale(stats[:, 0] - mu[:, 0])
    need(bool((stats[:, 1] > 0).all()) and err_mu <= 1e-5 * _ln_scale(mu)
         + 1e-6, f"layer_norm {label}: statistics off (mean {err_mu:.3e})")

    from torch.nn import functional as F

    def autograd_plain():
        xa = x.detach().requires_grad_()
        wa, ba = w.detach().requires_grad_(), b.detach().requires_grad_()
        torch.autograd.grad(layer_norm_plain(xa, wa, ba, eps), (xa, wa, ba),
                            dy)

    # torch's own LayerNorm wants its parameters in x's dtype on the card,
    # and then writes y in x's dtype: a yardstick, not the same function
    w_l, b_l, dy_l = w.to(x.dtype), b.to(x.dtype), dy.to(x.dtype)

    def library_fwd():
        F.layer_norm(x, (D,), w_l, b_l, eps)

    def library():
        xa = x.detach().requires_grad_()
        wa, ba = w_l.detach().requires_grad_(), b_l.detach().requires_grad_()
        out = F.layer_norm(xa, (D,), wa, ba, eps)
        torch.autograd.grad(out, (xa, wa, ba), dy_l)

    ms_f = time_ms(lambda: lnk.layer_norm_fwd(x, w, b, eps), reps)
    ms_b = time_ms(lambda: lnk.layer_norm_bwd(dy, x, w, stats), reps)
    plain_f = time_ms(lambda: layer_norm_plain(x, w, b, eps), 5, warmup=1)
    plain_b = time_ms(lambda: layer_norm_backward_plain(dy, x, w, eps), 5,
                      warmup=1)
    plain_both = time_ms(autograd_plain, 5, warmup=1)
    lib_f = time_ms(library_fwd, reps)
    lib_both = time_ms(library, reps)
    e = x.element_size()
    bytes_f = rows * D * (e + 4) + rows * 8 + 2 * D * 4
    bytes_b = rows * D * (e + 4 + e) + rows * 8 + 3 * D * 4
    bound_f = bytes_f / PEAK_BYTES_PER_S * 1e3
    bound_b = bytes_b / PEAK_BYTES_PER_S * 1e3
    say(f"[layer_norm {label}] ({rows}, {D}) {x.dtype}, eps {eps:g}: within "
        f"tolerance; fwd kernel_ms={ms_f:.5f} bound_ms={bound_f:.5f} "
        f"({100 * bound_f / ms_f:.1f}% of it) plain_ms={plain_f:.5f} "
        f"library_ms={lib_f:.5f}; bwd kernel_ms={ms_b:.5f} "
        f"bound_ms={bound_b:.5f} ({100 * bound_b / ms_b:.1f}%) "
        f"plain_ms={plain_b:.5f}; plain forward + autograd backward "
        f"{plain_both:.5f} ms, F.layer_norm forward + backward "
        f"{lib_both:.5f} ms; max err y {_ln_scale(err_y):.3e}, dx "
        f"{_ln_scale(err_dx):.3e}, dweight {_ln_scale(dw - dw_p):.3e}, "
        f"dbias {_ln_scale(db - db_p):.3e}")
    common = dict(route="cuda", source="tdr_torch/csrc/layer_norm.cu",
                  replaces="none (XLA fused tdr's LayerNorm)", shape=label,
                  bound_by="bytes", launches=0)
    return (dict(common, name="layer_norm_fwd", ms=ms_f, plain_ms=plain_f,
                 bound_ms=bound_f, library_ms=lib_f,
                 max_abs_err=_ln_scale(err_y)),
            dict(common, name="layer_norm_bwd", ms=ms_b, plain_ms=plain_b,
                 bound_ms=bound_b, library_ms=lib_both - lib_f,
                 plain_autograd_fwd_bwd_ms=plain_both,
                 max_abs_err=_ln_scale(err_dx)))


def layer_norm_phase(reps=20):
    """Phase 3d: the LayerNorm kernels against their plain versions at the
    train path's shape (262,144 x 384 bf16, eps 1e-6) and at BERT's (the
    converter's, 65,536 x 768 f32, eps 1e-12), with times; then one train
    step at ``DenseConfig()`` width launches each kernel 13 times (2 a
    block, 6 blocks, and the last).  Returns the train shape's records."""
    import torch
    from tdr_torch.utils.config import DenseConfig

    gen = torch.Generator(device=DEVICE).manual_seed(5)
    x = torch.randn(2048 * 128, 384, generator=gen, device=DEVICE)
    recs = check_layer_norm((x * 0.7 + 0.3).to(torch.bfloat16), 1e-6,
                            "train 262144x384 bf16")
    del x
    x = torch.randn(512 * 128, 768, generator=gen, device=DEVICE)
    check_layer_norm(x, 1e-12, "bert 65536x768 f32", seed=1)
    del x
    cfg = DenseConfig()
    counts = train_step_launches(cfg)
    want = 2 * cfg.depth + 1
    need(counts["layer_norm_fwd"] == want and counts["layer_norm_bwd"] == want,
         f"one train step launched the LayerNorm kernels "
         f"{counts['layer_norm_fwd']} and {counts['layer_norm_bwd']} times, "
         f"not {want}")
    say(f"one train step at DenseConfig() width: layer_norm_fwd "
        f"{counts['layer_norm_fwd']}, layer_norm_bwd "
        f"{counts['layer_norm_bwd']} launches")
    for rec in recs:
        rec["launches"] = counts[rec["name"]]
    return recs


def train_step_launches(cfg):
    """The kernel launches of one train step at ``cfg``'s width (8 pairs,
    every position valid), after a first step."""
    import numpy as np
    import torch
    from tdr_torch.train import create_train_state, make_train_step

    state = create_train_state(cfg, lr=2e-5, seed=0, device=DEVICE)
    rng = np.random.RandomState(0)
    B, L = 8, cfg.max_len
    batch = {"q_ids": rng.randint(1, cfg.vocab_size, (B, L)).astype(np.int32),
             "q_mask": np.ones((B, L), np.int32),
             "p_ids": rng.randint(1, cfg.vocab_size, (B, L)).astype(np.int32),
             "p_mask": np.ones((B, L), np.int32)}
    step = make_train_step()
    step(state, batch)
    _, counts = counted(lambda: step(state, batch))
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def _attention_operands(B, H, L, Dh, seed):
    """q, k, v as (B, H, L, Dh) views of three (B, L, H * Dh) bf16
    projections (the encoder's layout; q at twice the spread, so some rows'
    softmax is peaked), dO (B, L, H * Dh) bf16, and each position's
    validity: random lengths from 1 to L, the first sequence full, every
    eighth from the second on fully padded."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    x = [torch.randn(B, L, H * Dh, generator=gen, device=DEVICE) * sd
         for sd in (2.0, 1.0, 1.0)]
    q, k, v = (t.to(torch.bfloat16).view(B, L, H, Dh).transpose(1, 2)
               for t in x)
    dout = torch.randn(B, L, H * Dh, generator=gen,
                       device=DEVICE).to(torch.bfloat16)
    lengths = torch.randint(1, L + 1, (B,), generator=gen, device=DEVICE)
    lengths[0] = L
    lengths[1::8] = 0
    valid = torch.arange(L, device=DEVICE)[None, :] < lengths[:, None]
    return q, k, v, dout, valid


def _attention_reference(q, k, v, valid, dout):
    """The same function in IEEE f32 with no rounding between its steps
    (the divisor still bf16(sqrt(Dh))): the output and (dq, dk, dv)."""
    import torch
    from tdr_torch.ops.attention import attention_mask, scale_of
    from tdr_torch.ops.precision import ieee_f32

    B, H, L, Dh = q.shape
    with ieee_f32():
        qa, ka, va = (t.float().detach().requires_grad_() for t in (q, k, v))
        s = (qa / scale_of(Dh)) @ ka.transpose(-1, -2)
        s = s.masked_fill(~attention_mask(valid),
                          torch.finfo(torch.bfloat16).min)
        out = (torch.softmax(s, dim=-1) @ va).transpose(1, 2).reshape(
            B, L, H * Dh)
        grads = torch.autograd.grad(out, (qa, ka, va), dout.float())
    return (out.detach(),) + grads


def check_attention(B, H, L, Dh, label, reps=20, seed=0):
    """The attention kernels (``tdr_torch/csrc/attention.cu``) at (B, H, L,
    Dh) against the plain versions on the card and an unrounded f32
    reference, then (reps > 0) timed beside their bounds.  Returns the
    forward's and the backward's records.

    Tolerances: the kernels round at the plain versions' points, so they
    differ from them only where a sum taken in another order lands on the
    other side of a bf16 rounding point (S, then P, O and the gradients
    after it).  So each result's largest error against the f32 reference
    may be at most 1.5 times the plain bf16 ops' own, plus 2^-12 of the
    largest reference value; and exactly: a padded query row's dq is 0,
    every value is finite (a fully padded sequence too), each row's
    softmax sum is at least 1, and the backward repeats bit for bit.
    """
    import torch
    from torch.nn import functional as F
    from tdr_torch.ops import attention as ak
    from tdr_torch.ops.attention import (attend_backward_plain, attend_plain,
                                         attention_mask)

    q, k, v, dout, valid = _attention_operands(B, H, L, Dh, seed)
    out, stats = ak.attention_fwd(q, k, v, valid)
    grads = ak.attention_bwd(dout, q, k, v, valid, stats)
    again = ak.attention_bwd(dout, q, k, v, valid, stats)
    plain = (attend_plain(q, k, v, valid, torch.bfloat16),
             *attend_backward_plain(dout, q, k, v, valid))
    ref = _attention_reference(q, k, v, valid, dout)
    torch.cuda.synchronize()
    got = (out, *grads)
    if any(t.dtype != torch.bfloat16 for t in got):
        fail(f"attention {label}: dtypes {[t.dtype for t in got]}")
    errs = {}
    for name, a, p, r in zip(("out", "dq", "dk", "dv"), got, plain, ref):
        top = float(r.abs().max())
        e_k = float((a.float() - r).abs().max())
        e_p = float((p.float() - r).abs().max())
        errs[name] = (e_k, e_p, float((a.float() - p.float()).abs().max()))
        need(bool(torch.isfinite(a).all()),
             f"attention {label}: {name} not finite")
        need(e_k <= 1.5 * e_p + 2.0 ** -12 * top,
             f"attention {label}: {name} off the f32 reference by {e_k:.3e}, "
             f"the plain ops by {e_p:.3e}")
    pad_rows = ~valid[:, None, :, None].expand_as(grads[0])
    need(bool((grads[0][pad_rows] == 0).all()),
         f"attention {label}: a padded query row's dq is not 0")
    need(all(torch.equal(a, b) for a, b in zip(grads, again)),
         f"attention {label}: the backward does not repeat bit for bit")
    need(bool(torch.isfinite(stats).all() and (stats[..., 1] >= 1).all()),
         f"attention {label}: softmax statistics off")
    say(f"[attention {label}] within tolerance: max err against f32 "
        f"(kernel, plain, kernel-plain) "
        + ", ".join(f"{n} {a:.3e} {b:.3e} {c:.3e}"
                    for n, (a, b, c) in errs.items()))
    if reps <= 0:
        return None

    def forward_backward(fn, dy):
        def run():
            qa, ka, va = (t.detach().requires_grad_() for t in (q, k, v))
            torch.autograd.grad(fn(qa, ka, va), (qa, ka, va), dy)
        return run

    mask4 = attention_mask(valid)

    def sdpa(a, b, c):
        return F.scaled_dot_product_attention(a, b, c, attn_mask=mask4)

    ms_f = time_ms(lambda: ak.attention_fwd(q, k, v, valid), reps)
    ms_b = time_ms(lambda: ak.attention_bwd(dout, q, k, v, valid, stats),
                   reps)
    plain_f = time_ms(lambda: attend_plain(q, k, v, valid, torch.bfloat16),
                      5, warmup=1)
    plain_b = time_ms(lambda: attend_backward_plain(dout, q, k, v, valid),
                      5, warmup=1)
    plain_both = time_ms(forward_backward(
        lambda a, b, c: attend_plain(a, b, c, valid, torch.bfloat16), dout),
        5, warmup=1)
    lib_f = time_ms(lambda: sdpa(q, k, v), reps)
    lib_both = time_ms(forward_backward(
        sdpa, dout.view(B, L, H, Dh).transpose(1, 2)), reps)
    n = B * L * H * Dh
    bytes_f = 4 * n * 2 + B * L + B * H * L * 8
    bytes_b = 7 * n * 2 + B * L + B * H * L * 8
    flops_f = 4 * B * H * L * L * Dh
    flops_b = 10 * B * H * L * L * Dh
    bound_f = max(bytes_f / PEAK_BYTES_PER_S, flops_f / PEAK_BF16_FLOPS) * 1e3
    bound_b = max(bytes_b / PEAK_BYTES_PER_S, flops_b / PEAK_BF16_FLOPS) * 1e3
    by_f = "bytes" if bytes_f / PEAK_BYTES_PER_S >= flops_f / PEAK_BF16_FLOPS \
        else "operations"
    by_b = "bytes" if bytes_b / PEAK_BYTES_PER_S >= flops_b / PEAK_BF16_FLOPS \
        else "operations"
    say(f"[attention {label}] fwd kernel_ms={ms_f:.5f} bound_ms={bound_f:.5f} "
        f"({by_f}; {100 * bound_f / ms_f:.1f}% of it) plain_ms={plain_f:.5f} "
        f"library_ms={lib_f:.5f}; bwd kernel_ms={ms_b:.5f} "
        f"bound_ms={bound_b:.5f} ({by_b}; {100 * bound_b / ms_b:.1f}%) "
        f"plain_ms={plain_b:.5f}; plain forward + autograd backward "
        f"{plain_both:.5f} ms, SDPA forward + backward {lib_both:.5f} ms")
    common = dict(route="cuda", source="tdr_torch/csrc/attention.cu",
                  replaces="none (XLA computes tdr's attention)", shape=label,
                  launches=0)
    return (dict(common, name="attention_fwd", ms=ms_f, plain_ms=plain_f,
                 bound_ms=bound_f, bound_by=by_f, library_ms=lib_f,
                 max_abs_err=errs["out"][2]),
            dict(common, name="attention_bwd", ms=ms_b, plain_ms=plain_b,
                 bound_ms=bound_b, bound_by=by_b, library_ms=lib_both - lib_f,
                 plain_autograd_fwd_bwd_ms=plain_both,
                 max_abs_err=max(errs[n][2] for n in ("dq", "dk", "dv"))))


def attention_phase(reps=20):
    """Phase 3e: the attention kernels against their plain versions and an
    f32 reference at the train path's shape (2,048 x 12 x 128 x 32) and at
    (64, 12, 512, 64), with times; at small ragged shapes (every head width,
    L of 1, 32, 136 and 200) without; then one train step at
    ``DenseConfig()`` width launches each kernel 6 times (a block each).
    Returns the train shape's records."""
    from tdr_torch.utils.config import DenseConfig

    recs = check_attention(2048, 12, 128, 32, "train (2048, 12, 128, 32)",
                           reps)
    check_attention(64, 12, 512, 64, "long (64, 12, 512, 64)", reps, seed=1)
    for i, shape in enumerate(((8, 4, 32, 16), (16, 6, 200, 32),
                               (4, 2, 1, 64), (9, 5, 136, 64))):
        check_attention(*shape, f"small {shape}", reps=0, seed=2 + i)
    cfg = DenseConfig()
    counts = train_step_launches(cfg)
    need(counts["attention_fwd"] == cfg.depth
         and counts["attention_bwd"] == cfg.depth,
         f"one train step launched the attention kernels "
         f"{counts['attention_fwd']} and {counts['attention_bwd']} times, "
         f"not {cfg.depth}")
    say(f"one train step at DenseConfig() width: attention_fwd "
        f"{counts['attention_fwd']}, attention_bwd "
        f"{counts['attention_bwd']} launches")
    for rec in recs:
        rec["launches"] = counts[rec["name"]]
    return recs


def _ulp_gap(a, b):
    """Two f32 tensors' largest gap in units of the last place: (of each
    element's own value, of the tensor's largest |value|).  An element that
    cancels to near 0 (the lerp's m + w (g - m)) carries the rounding of
    its terms, so a kernel is held to the smaller of the two, 4 ulps."""
    import torch

    def ordered(t):
        i = t.view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    a, b = a.reshape(-1), b.reshape(-1)
    ulp = torch.finfo(torch.float32).eps * float(b.abs().max())
    own, top, worst = 0, 0.0, 0.0
    for s in range(0, a.numel(), 1 << 26):
        x, y = a[s:s + (1 << 26)], b[s:s + (1 << 26)]
        d = ordered(x) - ordered(y)
        own = max(own, int(d.abs().max()))
        gap = (x - y).abs() / ulp if ulp else d.abs().float()
        top = max(top, float(gap.max()))
        worst = max(worst, float(torch.minimum(d.abs().float(), gap).max()))
    return own, top, worst


def _device_ms(run, reps):
    """``run()``'s device operations (kernels and copies) by torch.profiler
    over ``reps`` calls after two: their summed time in ms, how many the
    profiler kept, and their names.  The profiler has been seen to drop an
    event of a run's last call, so a kernel's time a launch is the sum over
    the events kept."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type.name == "CUDA"]
    total = sum(e.time_range.end - e.time_range.start for e in dev)
    return total / 1e3, len(dev), sorted({e.name[:60] for e in dev})


def check_adamw(shapes, label, reps=10, seed=0):
    """The AdamW kernel (``tdr_torch/csrc/adamw.cu`` through
    ``ops.adamw.AdamW``) against torch's foreach path (``torch.optim.AdamW``,
    the plain version) on the card: parameters of ``shapes`` (f32, 0.02
    randn), both optimizers from one state (moments loaded at step 2), the
    same gradients for 3 steps; then the largest gaps of p, exp_avg and
    exp_avg_sq in ulps (``_ulp_gap``: each element within 4 ulps of its
    value or of the tensor's largest), one device operation a step (the
    kernel: no copy), and the device times a step of the kernel, the
    foreach path and ``torch._fused_adamw_`` (a yardstick: the port never
    calls it) beside the bound, 28 bytes a parameter at 3.35 TB/s, and
    the whole step's time with the host's share.  Returns the record."""
    import torch
    from tdr_torch.ops import adamw as ak
    from tdr_torch.ops import cuda_build
    from tdr_torch.train.contrastive import ADAM_BETAS, ADAM_EPS, \
        load_adam_moments

    lr, wd = 2e-5, 0.01                   # the train cells' configuration
    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def randn(shape, s):
        return s * torch.randn(shape, generator=gen, device=DEVICE)

    p0 = [randn(s, 0.02) for s in shapes]
    mu = {str(i): randn(s, 1e-3) for i, s in enumerate(shapes)}
    nu = {str(i): randn(s, 1e-3) ** 2 for i, s in enumerate(shapes)}
    sets = []
    for cls, kw in ((ak.AdamW, {}), (torch.optim.AdamW, {"foreach": True})):
        ps = [p.clone().requires_grad_() for p in p0]
        opt = cls(ps, lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS,
                  weight_decay=wd, **kw)
        load_adam_moments(opt, [(str(i), p) for i, p in enumerate(ps)], 2,
                          mu, nu)
        sets.append((ps, opt))
    del p0, mu, nu
    n = sum(math.prod(s) for s in shapes)
    grads = [torch.empty(s, device=DEVICE) for s in shapes]
    for ps, _ in sets:
        for p, g in zip(ps, grads):
            p.grad = g
    launches = []
    for _ in range(3):
        for g in grads:                   # in place: the table stays
            g.normal_(0.0, 1e-3, generator=gen)
        cuda_build.reset_launches()
        sets[0][1].step()
        launches.append(cuda_build.launches["adamw"])
        sets[1][1].step()
    torch.cuda.synchronize()
    (ka, kopt), (pa, popt) = sets
    need(launches == [1, 1, 1] and kopt.table_builds == 1,
         f"adamw {label}: {launches} launches over 3 steps, "
         f"{kopt.table_builds} tables built")
    gaps = {}
    for name in ("p", "exp_avg", "exp_avg_sq"):
        own, top, worst = 0, 0.0, 0.0
        for x, y in zip(ka, pa):
            a, b = ((x.detach(), y.detach()) if name == "p" else
                    (kopt.state[x][name], popt.state[y][name]))
            o, t, w = _ulp_gap(a, b)
            own, top, worst = max(own, o), max(top, t), max(worst, w)
        need(worst <= 4, f"adamw {label}: {name} {worst} ulps from the "
                         f"foreach path")
        gaps[name] = {"own": own, "of_largest": top}
    total, kept, names = _device_ms(kopt.step, reps)
    need(reps - 1 <= kept <= reps and all("adamw" in n for n in names),
         f"adamw {label}: {reps} steps ran {kept} device operations "
         f"{names}, not one kernel each")
    ms = total / kept
    total, kept, _ = _device_ms(popt.step, reps)
    plain, plain_ops = total / reps, kept / reps
    step_ms, plain_step_ms = time_ms(kopt.step, reps), time_ms(popt.step, reps)
    del ka, kopt, sets
    steps = [torch.tensor(3.0, device=DEVICE) for _ in pa]
    grads = [p.grad for p in pa]
    moments = [[popt.state[p][k] for p in pa]
               for k in ("exp_avg", "exp_avg_sq")]
    params = [p.detach() for p in pa]

    def library():
        torch._fused_adamw_(params, grads, *moments, [], steps, lr=lr,
                            beta1=ADAM_BETAS[0], beta2=ADAM_BETAS[1],
                            weight_decay=wd, eps=ADAM_EPS, amsgrad=False,
                            maximize=False)

    lib = _device_ms(library, reps)[0] / reps
    del pa, popt, params, grads, moments
    gc.collect()
    torch.cuda.empty_cache()
    bound = 28 * n / PEAK_BYTES_PER_S * 1e3
    say(f"[adamw {label}] {len(shapes)} tensors, {n} parameters: within "
        f"4 ulps of the foreach path over 3 steps (largest gap in ulps of "
        f"the value / of the tensor's largest: "
        + ", ".join(f"{k} {g['own']} / {g['of_largest']:.2f}"
                    for k, g in gaps.items())
        + f"); device time a step: kernel_ms={ms:.5f} "
        f"bound_ms={bound:.5f} ({100 * bound / ms:.1f}% of it) "
        f"plain_ms={plain:.5f} (foreach, {plain_ops:.0f} kernels) "
        f"library_ms={lib:.5f} (torch._fused_adamw_); a whole step, host "
        f"included: {step_ms:.5f} ms, foreach {plain_step_ms:.5f} ms")
    return dict(name="adamw", route="cuda",
                source="tdr_torch/csrc/adamw.cu",
                replaces="none (XLA fused optax.adamw a leaf)", shape=label,
                bound_by="bytes", launches=1, ms=ms, plain_ms=plain,
                bound_ms=bound, library_ms=lib, step_ms=step_ms,
                plain_step_ms=plain_step_ms, max_ulps=gaps)


def adamw_phase(reps=10):
    """Phase 3f: the AdamW kernel against torch's foreach path at MiniLM's
    ``DenseConfig()`` parameters (29.9M) and at one MoE layer's of
    DeepSeek-V2-Lite (the expert stacks, the shared experts, the gate, MLA
    and the norms), with times; then one train step at ``DenseConfig()``
    width launches it once, and three steps build its chunk table once
    (autograd's new gradient storage each step builds none).  Returns the
    MoE layer's record."""
    import numpy as np
    import torch
    from tdr_torch.models.encoder import DualEncoder
    from tdr_torch.models.mla_moe import Layer
    from tdr_torch.train import create_train_state, make_train_step
    from tdr_torch.utils.config import DenseConfig, MlaMoeConfig

    with torch.device("meta"):
        minilm = [tuple(p.shape) for p in DualEncoder(DenseConfig())
                  .parameters()]
        moe = [tuple(p.shape) for p in Layer(MlaMoeConfig(), moe=True)
               .parameters()]
    check_adamw(minilm, "MiniLM DenseConfig()", reps)
    rec = check_adamw(moe, "one DeepSeek-V2-Lite MoE layer", reps, seed=1)
    cfg = DenseConfig()
    counts = train_step_launches(cfg)
    need(counts["adamw"] == 1, f"one train step launched the AdamW kernel "
                               f"{counts['adamw']} times, not 1")
    state = create_train_state(cfg, lr=2e-5, seed=0, device=DEVICE)
    rng = np.random.RandomState(1)
    ids = rng.randint(1, cfg.vocab_size, (8, cfg.max_len)).astype(np.int32)
    mask = np.ones((8, cfg.max_len), np.int32)
    step = make_train_step()
    for _ in range(3):
        step(state, {"q_ids": ids, "q_mask": mask, "p_ids": ids[::-1].copy(),
                     "p_mask": mask})
    torch.cuda.synchronize()
    builds = state.optimizer.table_builds
    del state
    gc.collect()
    torch.cuda.empty_cache()
    need(builds == 1, f"three train steps built {builds} AdamW chunk "
                      f"tables, not 1")
    say(f"one train step at DenseConfig() width: adamw {counts['adamw']} "
        f"launch; three steps built {builds} chunk table")
    return rec


def dense_phase(corpus, queries, bench_emb, bench_q, reps, profile=False):
    """Phase 7: the dense path, and 9b: K3's f32 body at the pass's shape;
    returns K3's records (bf16, f32) at the pass's shape, the dense model
    and the encoded queries."""
    import numpy as np
    import torch
    from tdr_torch import native
    from tdr_torch.eval import recall_at_k
    from tdr_torch.models.dense import (DenseModel, build_ivf_index,
                                        flat_search, ivf_search)
    from tdr_torch.models.encoder import init_encoder
    from tdr_torch.ops import cuda_build
    from tdr_torch.ops.fused_flat import fused_flat_available
    from tdr_torch.utils.config import DenseConfig

    # the dense times include hashing: hold them to the native hasher, not
    # the pure-Python oracle that encode_batch takes without it
    if not native.available():
        fail("the native hasher (tdr_torch/native) did not build or load")
    cfg = DenseConfig()
    model = init_encoder(cfg, seed=0, device=DEVICE)
    t0 = time.perf_counter()
    dense = DenseModel.build(model, cfg, corpus.texts, corpus.docids,
                             batch=256)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    emb = dense.flat.embeddings
    say(f"[dense] encoder dim {cfg.dim} depth {cfg.depth} heads {cfg.heads} "
        f"vocab {cfg.vocab_size} max_len {cfg.max_len} {cfg.dtype}; native "
        f"hasher; build "
        f"over {len(corpus.texts)} docs: {build_s:.1f} s, flat index "
        f"{tuple(emb.shape)} {emb.dtype} "
        f"({emb.numel() * emb.element_size() / 1e6:.1f} MB)")
    if not fused_flat_available(emb):
        fail("the dense index does not pass the fused engine's gate")

    nq = len(queries.queries)
    cuda_build.reset_launches()
    results = dense.retrieve(queries.queries, k=10)
    torch.cuda.synchronize()
    counts = dict(cuda_build.launches)
    say(f"[dense] launches in one {nq}-query retrieve: {counts}")
    if counts["fused_flat"] == 0:
        fail("fused_flat never launched on the dense path")
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        results = dense.retrieve(queries.queries, k=10)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    q_enc = dense.encode_queries(queries.queries)
    search = []
    for _ in range(reps):
        t0 = time.perf_counter()
        flat_search(dense.flat, q_enc, 10)
        torch.cuda.synchronize()
        search.append(time.perf_counter() - t0)
    smed = statistics.median(search)
    if profile:
        profile_pass("dense", lambda: dense.retrieve(queries.queries, k=10))
    recall = recall_at_k(results, queries.positive_docs, 10)
    if any(len(r) != 10 for r in results):
        fail("a dense query returned fewer than 10 docs")
    say(f"[dense] retrieve (encode + search): median {med:.4f} s of "
        f"{[round(t, 4) for t in times]} -> {nq / med:.1f} queries/s; search "
        f"only: median {smed * 1e3:.3f} ms of "
        f"{[round(t * 1e3, 3) for t in search]} -> {nq / smed:.1f} queries/s; "
        f"recall@10 {recall:.4f} (untrained encoder: reported, no floor)")

    rec = check_fused_flat(dense.flat, q_enc, "dense pass", reps=10)
    rec["launches"] = counts["fused_flat"]

    # reference: the fused engine against the plain product + top-k
    fv, fr = flat_search(dense.flat, q_enc[:256], 10, engine="fused")
    pv, pr = flat_search(dense.flat, q_enc[:256], 10, engine="plain")
    fv, fr, pv, pr = (t.cpu().numpy() for t in (fv, fr, pv, pr))
    if not np.isfinite(fv).all():
        fail("dense reference: non-finite scores")
    for i in range(fv.shape[0]):
        if not same_ranking(fr[i], fv[i], pr[i], pv[i], rtol=1e-5, atol=1e-5):
            fail(f"dense reference: query {i} differs between engines")
    say(f"[dense reference] 256 queries: fused engine == plain engine "
        f"({int((fr != pr).sum())} rank slots inside near-ties)")
    rec_f32 = f32_flat_phase(dense.flat, q_enc, reps)

    # IVF on the bench embeddings (bench.py:896-900)
    t0 = time.perf_counter()
    ivf = build_ivf_index(bench_emb, nlist=512, device=DEVICE)
    torch.cuda.synchronize()
    ivf_build = time.perf_counter() - t0
    bq = torch.as_tensor(bench_q, device=DEVICE)
    ivf_ms = time_ms(lambda: ivf_search(ivf, bq, 10, nprobe=16), 5, warmup=1)
    _, r_ivf = ivf_search(ivf, bq, 10, nprobe=16)
    exact = flat_index_on_card(bench_emb, "ip", "float32")
    _, r_ex = flat_search(exact, bq, 10, engine="plain")
    r_ivf, r_ex = r_ivf.cpu().numpy(), r_ex.cpu().numpy()
    overlap = float(np.mean([len(set(a) & set(b)) / 10.0
                             for a, b in zip(r_ivf, r_ex)]))
    say(f"[dense ivf] nlist 512 (bucket_pad {ivf.bucket_pad}), build "
        f"{ivf_build:.1f} s; nprobe 16: {ivf_ms:.3f} ms per {bq.shape[0]} "
        f"queries -> {bq.shape[0] / ivf_ms * 1e3:.1f} queries/s, top-10 "
        f"overlap with exact "
        f"{overlap:.4f}")
    return rec, rec_f32, dense, q_enc


def f32_flat_phase(flat, q_enc, reps):
    """9b: an f32 copy of the dense pass's index through K3's f32 body
    (3xTF32): ``check_fused_flat`` at the pass's shape, one ``flat_search``
    of all the queries (launches counted, median of ``reps`` passes after a
    warm one), its lists against the plain engine's.  Returns the record."""
    import numpy as np
    from tdr_torch.models.dense import flat_search

    f32 = dataclasses.replace(flat, embeddings=flat.embeddings.float())
    rec = check_fused_flat(f32, q_enc, "f32 dense pass", reps=5)
    (fv, fr), counts = counted(lambda: flat_search(f32, q_enc, 10))
    need(counts["fused_flat_f32"] == 1 and counts["fused_flat"] == 0,
         f"9b: the f32 search did not run K3's f32 body once: {counts}")
    rec["launches"] = counts["fused_flat_f32"]
    med, times = timed(lambda: flat_search(f32, q_enc, 10), reps)
    # 20 deep, as in check_fused_flat
    pv, pr = flat_search(f32, q_enc, 20, engine="plain")
    fv, fr, pv, pr = (t.cpu().numpy() for t in (fv, fr, pv, pr))
    need(bool(np.isfinite(fv).all()), "9b: non-finite scores")
    bad = lists_match(fr, fv, pr, pv, atol=1e-5)
    need(not bad, f"9b: the f32 search differs from the plain engine at "
                  f"queries {bad[:10]}")
    nq = q_enc.shape[0]
    say(f"[9b f32 flat] emb {tuple(f32.embeddings.shape)} f32 "
        f"({f32.embeddings.numel() * 4 / 1e6:.1f} MB), {nq} queries: "
        f"launches {counts}; flat_search median {med * 1e3:.3f} ms of "
        f"{[round(t * 1e3, 3) for t in times]} -> {nq / med:.1f} queries/s; "
        f"lists == the plain engine's "
        f"({int((fr != pr[:, :10]).sum())} rank slots inside near-ties)")
    del f32
    return rec


def f32_heads_phase(corpus, queries, reps, bf16_med, profile=False):
    """9a: the sparse pass at ``head_dtype="float32"`` under an 8 GiB head
    budget (the 4 GiB bf16 build's head slots): en a full-vocab f32 head
    through K2's f32 body.  Build seconds, launches of one pass (K2 f32
    once per en batch), the median of ``reps`` passes after a warm one
    against the bf16 pass's ``bf16_med`` of this process, recall@10, and
    the lists against the same models on the scatter path
    (``use_fused_topk=False``, no kernel).  Returns the pass's counts, the
    models, and the queries with the scatter path's lists."""
    import torch
    from tdr_torch.eval import recall_at_k
    from tdr_torch.ops.fused_head import fused_head_available
    from tdr_torch.rank import LanguageRouter, build_language_models
    from tdr_torch.utils.config import IndexConfig

    t0 = time.perf_counter()
    models = build_language_models(
        corpus, index_cfg=IndexConfig(head_dtype="float32",
                                      head_budget_bytes=2 * HEAD_BUDGET),
        device=DEVICE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    en = models["en"].index
    need(en.head_rows.dtype == torch.float32
         and en.head_size == en.vocab_size and fused_head_available(en),
         f"9a: en is not a full-vocab f32 head on the fused engine "
         f"({en.head_rows.dtype}, head {en.head_size} of {en.vocab_size})")
    qs, langs = queries.queries, queries.langs
    want = -(-sum(1 for l in langs if l == "en") // 256)
    router = LanguageRouter(models, query_batch=256)
    (docs, scores), counts = counted(
        lambda: router.retrieve_with_scores(qs, langs, k=10))
    need(counts["fused_head_f32"] == want and counts["fused_head"] == 0,
         f"9a: K2's f32 body launched {counts['fused_head_f32']} times, "
         f"{want} expected (one per en batch): {counts}")
    med, times = timed(lambda: router.retrieve(qs, langs, k=10), reps)
    if profile:
        profile_pass("sparse f32 heads",
                     lambda: router.retrieve(qs, langs, k=10))
    recall = recall_at_k(docs, queries.positive_docs, 10)
    need(all(len(d) == 10 for d in docs), "9a: a query returned fewer than "
                                          "10 docs")
    plain = {l: dataclasses.replace(m, use_fused_topk=False)
             for l, m in models.items()}
    (pdocs, pscores), pcounts = counted(
        lambda: LanguageRouter(plain, query_batch=256).retrieve_with_scores(
            qs, langs, k=10))
    need(pcounts["fused_head_f32"] == 0 and pcounts["tail_compact"] == 0,
         f"9a: the scatter reference launched a kernel: {pcounts}")
    bad = lists_match(docs, scores, pdocs, pscores)
    need(not bad, f"9a: the f32-head pass differs from the scatter path at "
                  f"queries {bad[:10]}")
    heads = ", ".join(f"{l} {m.index.head_size}"
                      for l, m in sorted(models.items()))
    say(f"[9a f32 heads] build {build_s:.1f} s (head slots: {heads}); "
        f"{len(qs)} queries: median {med:.4f} s of "
        f"{[round(t, 4) for t in times]} -> {len(qs) / med:.1f} queries/s "
        f"({med / bf16_med:.2f}x the bf16 pass's {bf16_med:.4f} s in this "
        f"process); recall@10 {recall:.4f}; launches in one pass {counts}; "
        f"lists == the scatter path's")
    del router, plain
    return counts, models, dict(queries=qs, langs=langs,
                                lists=(pdocs, pscores))


def counted(run):
    """Run ``run()`` with the launch counts set to 0 just before and read
    just after: (result, counts)."""
    import torch
    from tdr_torch.ops import cuda_build

    cuda_build.reset_launches()
    out = run()
    torch.cuda.synchronize()
    return out, dict(cuda_build.launches)


def timed(run, reps):
    """(median seconds, all seconds) of ``reps`` passes after one warm pass."""
    import torch

    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), times


def need(cond, msg):
    if not cond:
        fail(msg)


def check_recall(label, got, want, tol=0.003):
    need(abs(got - want) <= tol + 1e-9,
         f"{label} recall@10 {got:.4f} outside {want} +- {tol} (the JAX "
         f"recall on this corpus)")


def lists_match(docs_a, scores_a, docs_b, scores_b, skip=(), rtol=1e-5,
                atol=1e-4):
    """Indices of queries whose lists differ beyond near-ties (skipping
    ``skip``)."""
    return [q for q in range(len(docs_a)) if q not in skip and not
            same_ranking(docs_a[q], scores_a[q], docs_b[q], scores_b[q],
                         rtol=rtol, atol=atol)]


def prf_phase(models, queries, reps, profile=False):
    """8a: PRF through the router, with and without spell repair; the K1
    and K2 launches of one pass, the overflowed share of the second pass,
    K1 against its plain version on es's first expanded batch, and the
    pass against the scatter path."""
    import torch
    from tdr_torch.eval import recall_at_k
    from tdr_torch.ops import tail_compact as tc
    from tdr_torch.rank import LanguageRouter
    from tdr_torch.rank.feedback import prf_mine, relevance_doc_weights
    from tdr_torch.text.fast import fast_tokenize_texts

    qs, langs, pos = queries.queries, queries.langs, queries.positive_docs
    t0 = time.perf_counter()
    for m in models.values():
        m._doc_major()
    torch.cuda.synchronize()
    say(f"[8a prf] doc-major mirrors of {len(models)} indexes built in "
        f"{time.perf_counter() - t0:.2f} s (one time, host numpy); p_doc "
        + ", ".join(f"{l} {m._doc_major().p_doc}"
                    for l, m in sorted(models.items())))
    prf_models = {l: dataclasses.replace(m, prf=True) for l, m in models.items()}
    router = LanguageRouter(prf_models, query_batch=256)
    (docs, scores), counts = counted(
        lambda: router.retrieve_with_scores(qs, langs, k=10))
    need(counts["tail_compact"] > 0 and counts["fused_head"] > 0,
         f"PRF pass missed a kernel: {counts}")
    med, times = timed(lambda: router.retrieve(qs, langs, k=10), reps)
    if profile:
        profile_pass("prf", lambda: router.retrieve(qs, langs, k=10))
    recall = recall_at_k(docs, pos, 10)
    # per batch, as the router cuts them: the expansions of the fused path
    # and of the scatter path (the reference below), and the second pass's
    # overflowed share through the compaction's own bookkeeping.  A query
    # whose expansion differs must hold a near-tie (rtol 1e-5) that the
    # paths' summation orders may break either way: at the edge of its F
    # feedback docs, or between two adjacent of its top E + 1 mined totals
    plain = {l: dataclasses.replace(m, use_fused_topk=False)
             for l, m in prf_models.items()}
    over = n_tail = 0
    skip = set()
    for lang, m in sorted(prf_models.items()):
        sel = [i for i, l in enumerate(langs) if l == lang]
        budget = min(max(m.tail_budget, 4 * m.index.tail_pmax),
                     16 * m.index.tail_pmax)
        for s in range(0, len(sel), 256):
            idx = sel[s:s + 256]
            toks = fast_tokenize_texts([qs[i] for i in idx], lang)
            enc = m.encode_query_tokens(toks + [[]] * (256 - len(toks)))
            q2, w2 = m._prf_expand(*enc)
            p2, v2 = plain[lang]._prf_expand(*enc)
            T = enc[0].shape[1]
            same = ((q2[:, T:] == p2[:, T:]).all(dim=1)
                    & torch.isclose(w2[:, T:], v2[:, T:], rtol=1e-4,
                                    atol=0).all(dim=1)).tolist()
            F, E = m.prf_docs, m.prf_terms
            fv, fr = m._score_encoded(*enc, F + 1)
            w_d, fin = relevance_doc_weights(fv, F)
            _, tot, _ = prf_mine(m._doc_major(), m.index.vocab_size, *enc,
                                 w_d, fr[:, :F], fin, n_expand=E + 1,
                                 min_docs=m.prf_min_docs)
            adj = (torch.isclose(tot[:, :-1], tot[:, 1:], rtol=1e-5, atol=0)
                   & torch.isfinite(tot[:, 1:]))
            tie = (torch.isclose(fv[:, F - 1], fv[:, F], rtol=1e-5, atol=0)
                   & torch.isfinite(fv[:, F])) | adj.any(dim=1)
            for i, ok, t in zip(idx, same, tie.tolist()):
                if not ok:
                    need(t, f"query {i} ({lang}) expands otherwise on the "
                            f"scatter path with no near-tie in its first "
                            f"pass or mined totals")
                    skip.add(i)
            if m.index.head_size < m.index.vocab_size:
                over += int(tc.tail_segments(m.index, q2, w2, budget)[4].sum())
                n_tail += len(idx)
            if lang == "es" and s == 0:
                # K1 on a PRF-expanded batch: T + E terms cross 32-term chunks
                check_tail_compact(m.index, q2, w2,
                                   f"es PRF-expanded T={q2.shape[1]}", budget)
    both = LanguageRouter({l: dataclasses.replace(m, prf=True,
                                                  spell_correct=True)
                           for l, m in models.items()}, query_batch=256)
    t0 = time.perf_counter()
    both.retrieve(qs[:1], langs[:1], k=10)
    spell_build = time.perf_counter() - t0
    res_both = both.retrieve(qs, langs, k=10)
    recall_both = recall_at_k(res_both, pos, 10)
    say(f"[8a prf] {len(qs)} queries, F=3 E=5 beta=0.3 min_docs=2: median "
        f"{med:.4f} s of {[round(t, 4) for t in times]} -> "
        f"{len(qs) / med:.1f} queries/s; launches in one pass {counts}; "
        f"second pass overflowed {over} of {n_tail} tail-language queries "
        f"({100 * over / max(n_tail, 1):.2f}%, {100 * over / len(qs):.2f}% of "
        f"all); recall@10 {recall:.4f}; with spell repair {recall_both:.4f} "
        f"(repairers built in {spell_build:.2f} s)")
    check_recall("PRF", recall, 0.769)
    check_recall("PRF + spell", recall_both, 0.7975)

    # reference: the same pass scored through the scatter path (no kernel),
    # every batch padded to 256 on both sides: the row-gather head of the
    # small buckets contracts the (non-integral) expansion weights in f32,
    # the product paths in the head's bf16.  Queries whose expansion
    # differs between the two paths (each shown above to hold a near-tie)
    # are counted and left out.
    docs, scores = LanguageRouter(prf_models, query_batch=256,
                                  query_buckets=()).retrieve_with_scores(
        qs, langs, k=10)
    (pdocs, pscores), pcounts = counted(
        lambda: LanguageRouter(plain, query_batch=256, query_buckets=())
        .retrieve_with_scores(qs, langs, k=10))
    need(pcounts["tail_compact"] == 0 and pcounts["fused_head"] == 0,
         f"the scatter reference launched a kernel: {pcounts}")
    bad = lists_match(docs, scores, pdocs, pscores, skip)
    need(not bad, f"PRF pass differs from the scatter path at queries "
                  f"{bad[:10]}")
    say(f"[8a prf reference] PRF pass == scatter-path PRF pass on "
        f"{len(qs) - len(skip)} queries ({len(skip)} left out: their "
        f"expansion terms differ, or weights beyond rtol 1e-4, between the "
        f"paths, each at a near-tie)")
    return counts


def topk_modes_phase(models, queries, full_docs, full_scores):
    """8b: the router in exact_compact and approx mode against exact."""
    from tdr_torch.ops import score
    from tdr_torch.rank import LanguageRouter

    out = {}
    for mode in ("exact_compact", "approx"):
        router = LanguageRouter({l: dataclasses.replace(m, topk_mode=mode)
                                 for l, m in models.items()}, query_batch=256)
        score.reset_tier2_stats()
        (docs, scores), counts = counted(lambda: router.retrieve_with_scores(
            queries.queries, queries.langs, k=10))
        st = dict(score.tier2_stats[mode])
        bad = lists_match(docs, scores, full_docs, full_scores)
        need(not bad, f"{mode}: lists differ from exact at queries {bad[:10]}")
        t0 = time.perf_counter()
        router.retrieve(queries.queries, queries.langs, k=10)
        import torch
        torch.cuda.synchronize()
        say(f"[8b {mode}] {len(docs)} queries == exact mode's top-10 (but "
            f"near-ties); tier 2 tripped on {st['trips']} of {st['batches']} "
            f"tier-1 batches; launches {counts}; pass "
            f"{time.perf_counter() - t0:.4f} s")
        out[mode] = counts
    return out


def segmented_phase(models, queries, reps):
    """8c: the en model in a SegmentedBM25 store: 100 added docs, passes at
    each tombstone margin, store-level PRF."""
    import numpy as np
    import torch
    from tdr_torch.rank import SegmentedBM25
    from tdr_torch.rank.router import _gather_results
    from tdr_torch.text import preprocess_texts
    from tdr_torch.text.fast import fast_tokenize_texts
    from tdr_torch.utils.config import IndexConfig

    main = models["en"]
    seg = SegmentedBM25(main=main, lang="en",
                        index_cfg=IndexConfig(head_budget_bytes=HEAD_BUDGET))
    new_texts = [f"freshdoc {i} zyqx{i} kwv{i} live segment update"
                 for i in range(100)]
    new_toks = preprocess_texts(new_texts, ["en"] * 100)
    t0 = time.perf_counter()
    seg.add_documents(new_toks, [f"live{i}" for i in range(100)])
    torch.cuda.synchronize()
    add_s = time.perf_counter() - t0
    hits = sum(seg.retrieve_tokens([[f"zyqx{i}"]], k=3)[0][:1] == [f"live{i}"]
               for i in range(0, 100, 10))
    need(hits == 10, f"segment store: {hits}/10 added docs came back")
    en_q = [q for q, l in zip(queries.queries, queries.langs) if l == "en"]
    qset = fast_tokenize_texts(en_q[:768], "en")

    def main_pass():
        pend = [main.topk_tokens_async(qset[s:s + 256], 10, pad_to=256)
                for s in range(0, len(qset), 256)]
        _gather_results([p[0] for p in pend], [p[1] for p in pend])

    main_med, _ = timed(main_pass, reps)
    seg_med, seg_times = timed(lambda: seg.topk_tokens(qset, k=10), reps)
    say(f"[8c segmented] en main {main.index.n_docs} docs + 100 added in "
        f"{add_s:.3f} s: 10/10 added docs retrievable; {len(qset)}-query "
        f"pass median {seg_med:.4f} s of {[round(t, 4) for t in seg_times]} "
        f"({len(qset) / seg_med:.1f} queries/s) vs the main model alone "
        f"{main_med:.4f} s (ratio {seg_med / main_med:.2f})")
    counts_all = {}
    # tombstone margins: 48 dead rows -> k_seg 74, 192 -> 266, 250 -> 1034;
    # the deleted docs are the store's own top hits.  At each margin the
    # lists are held against the same store with a scatter-scored main
    # segment (no kernel), which checks K2's wide-top_k rescore chunks
    vals, rows = seg.topk_tokens(qset, k=10)
    ids = seg.docids
    top = list(dict.fromkeys(ids[r] for r in rows[:, 0]))
    deleted = []
    for n_dead, want_k in ((48, 74), (192, 266), (250, 1034)):
        more = [d for d in top if d not in deleted][:n_dead - len(deleted)]
        need(len(more) == n_dead - len(deleted), "too few distinct top hits")
        seg.delete_documents(more)
        deleted += more
        need(seg._k_seg(10) == want_k, f"k_seg {seg._k_seg(10)} != {want_k}")
        (vals, rows), counts = counted(lambda: seg.topk_tokens(qset, k=10))
        need(counts["fused_head"] > 0, f"k_seg {want_k}: K2 did not launch")
        got = {ids[r] for r, v in zip(rows.ravel(), vals.ravel())
               if np.isfinite(v)}
        need(not got & set(deleted), f"k_seg {want_k}: a deleted doc came back")
        need(np.isfinite(vals).all(), f"k_seg {want_k}: fewer than 10 docs")
        plain = dataclasses.replace(
            seg, main=dataclasses.replace(main, use_fused_topk=False))
        (pvals, prows), pcounts = counted(lambda: plain.topk_tokens(qset, k=11))
        need(pcounts["fused_head"] == 0,
             f"k_seg {want_k}: the scatter reference launched K2: {pcounts}")
        bad = lists_match(rows.tolist(), vals, prows.tolist(), pvals)
        need(not bad, f"k_seg {want_k}: lists differ from the scatter-scored "
                      f"store at queries {bad[:10]}")
        med, _ = timed(lambda: seg.topk_tokens(qset, k=10), 1)
        counts_all[want_k] = counts
        say(f"[8c segmented] {len(deleted)} deleted (k_seg {want_k}): none "
            f"returned, 10 live docs per query, {len(qset)} lists == the "
            f"scatter-scored store's; launches {counts}; pass "
            f"{med:.4f} s; truncated queries so far {seg.truncated_queries}")
    seg.prf = True
    (_, _), counts = counted(lambda: seg.topk_tokens(qset[:256], k=10))
    prf_med, prf_times = timed(lambda: seg.topk_tokens(qset[:256], k=10), 3)
    seg.prf = False
    say(f"[8c segmented prf] 256 queries: median {prf_med:.4f} s of "
        f"{[round(t, 4) for t in prf_times]}; launches {counts}")
    counts_all["prf"] = counts
    return counts_all


def candidates_phase(models, queries):
    """8d: es's first 256 queries (all 80 on the 2000-query set) and their
    own top-200, re-scored by score_candidates_fused (K1) and by
    score_pairs."""
    import numpy as np
    import torch
    from tdr_torch.ops.score import score_candidates_fused, score_pairs
    from tdr_torch.text.fast import fast_tokenize_texts

    lang = "es"
    m = models[lang]
    qs = [q for q, l in zip(queries.queries, queries.langs) if l == lang][:256]
    qids, qw = m.encode_query_tokens(fast_tokenize_texts(qs, lang))
    vals, cand = m._score_encoded(qids, qw, 200)
    (fused, counts) = counted(lambda: score_candidates_fused(
        m.index, qids, qw, cand, tail_budget=m.tail_budget))
    need(counts["tail_compact"] > 0, "score_candidates_fused: K1 never ran")
    pairs = score_pairs(m.index, qids, qw, cand)
    head_w = torch.where(m.index.head_slot[qids.long()] >= 0, qw,
                         torch.zeros_like(qw))
    bound = 2.0 ** -8 * score_pairs(m.index, qids, head_w, cand) + 1e-4
    err = (fused - pairs).abs()
    need(bool((err <= bound).all()), f"fused re-score beyond the bf16 bound "
         f"(max excess {(err - bound).max().item():.3e})")
    fin = torch.isfinite(vals)
    need(bool(torch.allclose(fused[fin], vals[fin], rtol=1e-5, atol=1e-4)),
         "fused re-score differs from the model's own top-200 scores")
    # the top-10 of either scoring; where a rank holds another doc, the
    # exact (pairs) score of the fused pick must be within twice the bound
    # of the exact score at that rank
    _, fs = torch.sort(fused, dim=1, descending=True, stable=True)
    pv, ps = torch.sort(pairs, dim=1, descending=True, stable=True)
    fr, pr = cand.gather(1, fs[:, :10]), cand.gather(1, ps[:, :10])
    pf = pairs.gather(1, fs[:, :10])
    fr, pr, pf, pv = (t.cpu().numpy() for t in (fr, pr, pf, pv[:, :10]))
    bnd = bound.max(dim=1).values.cpu().numpy()
    diff = fr != pr
    need(bool((np.abs(pf - pv)[diff] <= 2 * np.repeat(bnd, 10).reshape(
        diff.shape)[diff]).all()), "top-10 differs beyond the bf16 bound")
    swaps = int(diff.sum())
    f_ms = time_ms(lambda: score_candidates_fused(m.index, qids, qw, cand,
                                                  tail_budget=m.tail_budget), 5)
    p_ms = time_ms(lambda: score_pairs(m.index, qids, qw, cand), 5)
    say(f"[8d candidates] {lang}: {len(qs)} queries x their own top-200: "
        f"score_candidates_fused within the bf16 bound of score_pairs (max "
        f"abs diff {err.max().item():.3e}), equal to the model's scores; "
        f"top-10 equal but {swaps} swaps inside the bound; launches "
        f"{counts}; fused {f_ms:.3f} ms, pairs {p_ms:.3f} ms for the "
        f"{len(qs)} x 200 pairs")
    return counts


def cascade_phase(reps, n_docs=207_363, n_queries=1000):
    """8e: the cosine -> BM25 cascade at the JAX bench's configuration
    (bench.py:357-396)."""
    import torch
    from tdr_torch.data import SyntheticSpec, synthetic_corpus
    from tdr_torch.eval import recall_at_k
    from tdr_torch.models.sparse import BM25Model, TfidfCosineModel
    from tdr_torch.rank import CascadeRetriever
    from tdr_torch.text.fast import fast_encode_corpus
    from tdr_torch.utils.config import IndexConfig

    t0 = time.perf_counter()
    corpus, queries = synthetic_corpus(SyntheticSpec(
        n_docs=n_docs, n_queries=n_queries, seed=7, hard=True,
        ref_proportions=False, langs=("en",)))
    t_corpus = time.perf_counter() - t0
    cfg = IndexConfig(head_budget_bytes=1 << 30)
    t0 = time.perf_counter()
    vocab, *coo = fast_encode_corpus(corpus.texts, ["en"] * len(corpus.texts))
    cand = TfidfCosineModel.from_coo(vocab, tuple(coo), corpus.docids,
                                     lang="en", index_cfg=cfg, device=DEVICE)
    rank = BM25Model.from_coo(vocab, tuple(coo), corpus.docids, lang="en",
                              index_cfg=cfg, device=DEVICE)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    cas = CascadeRetriever({"en": cand}, {"en": rank}, candidates=200,
                           query_batch=256)
    cas.retrieve(queries.queries[:1], ["en"], k=10)
    res, counts = counted(lambda: cas.retrieve(queries.queries, queries.langs,
                                               k=10))
    need(counts["tail_compact"] > 0, f"cascade: K1 never ran {counts}")
    med, times = timed(lambda: cas.retrieve(queries.queries, queries.langs,
                                            k=10), reps)
    recall = recall_at_k(res, queries.positive_docs, 10)
    ix = rank.index
    say(f"[8e cascade] en {ix.n_docs} docs (corpus {t_corpus:.1f} s, both "
        f"stage indexes {t_build:.1f} s; head {ix.head_size} of vocab "
        f"{ix.vocab_size}, tail_pmax {ix.tail_pmax}), candidates 200, batch "
        f"256: median {med:.4f} s of {[round(t, 4) for t in times]} for "
        f"{len(res)} queries -> {len(res) / med:.1f} queries/s, recall@10 "
        f"{recall:.4f}; launches in one pass {counts}")
    check_recall("cascade", recall, 0.774)
    return counts, (cas, queries, res)


def bert_token_flops(cfg, seq_len: int) -> float:
    """FLOP of one token through a BERT stack at ``seq_len`` (the padded
    length every position runs at): the q/k/v/out and MLP products plus the
    attention's two (seq_len x head_dim) products per head, 2 per MAC."""
    dense = 4 * cfg.dim * cfg.dim + 2 * cfg.dim * cfg.mlp_hidden
    return 2.0 * cfg.depth * (dense + 2 * seq_len * cfg.dim)


def sentence_phase(n_docs=100_000, n_dev=200, n_eval=500, seq_len=32,
                   profile=False):
    """10: the sentence-BM25 -> BERT re-rank cascade at MiniLM-L12 width on
    the JAX bench's sentence corpus (bench.py:417-422, :463-507), with
    random seeded weights (the pretrained checkpoint is not in the
    repository).  ``profile`` traces 32 batches of the embedding pass and
    one eval pass.  Returns the launches of the eval pass, and the corpus,
    queries and sentence index for phase 11."""
    import copy

    import numpy as np
    import torch
    from tdr_torch.data import SyntheticSpec, synthetic_corpus
    from tdr_torch.eval import recall_at_k
    from tdr_torch.models.convert import init_bert_encoder, minilm_l12_config
    from tdr_torch.models.dense import DenseModel
    from tdr_torch.models.encoder import encode
    from tdr_torch.rank import SentenceBM25, SentenceLmCascade
    from tdr_torch.text.hash_tokenizer import encode_batch
    from tdr_torch.utils.config import DenseConfig, IndexConfig

    t_phase = time.perf_counter()
    corpus, queries = synthetic_corpus(SyntheticSpec(
        n_docs=n_docs, n_queries=n_dev + n_eval, seed=7, hard=True,
        ref_proportions=False, langs=("en",), sentences_per_doc=6))
    t0 = time.perf_counter()
    sb = SentenceBM25.build(corpus.docids, corpus.texts, "en",
                            index_cfg=IndexConfig(head_budget_bytes=1 << 30),
                            device=DEVICE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ix = sb.model.index
    S = len(sb.texts)
    say(f"[10 sentence cascade] {n_docs} docs -> {S} sentences; index head "
        f"{ix.head_size} of vocab {ix.vocab_size}, tail_pmax "
        f"{ix.tail_pmax}; corpus + build {time.perf_counter() - t_phase:.1f} "
        f"s (build {build_s:.1f} s)")

    bcfg = minilm_l12_config()
    bert = init_bert_encoder(bcfg, seed=0, device=DEVICE)
    dense = DenseModel.build(bert, DenseConfig(
        vocab_size=bcfg.vocab_size, dim=bcfg.dim, max_len=seq_len),
        corpus.texts[:1], corpus.docids[:1], batch=32)

    # the card's encoder against the same module on the CPU
    ids, mask = encode_batch(sb.texts[:64], bcfg.vocab_size, seq_len)
    on_card = encode(bert, ids, mask).cpu()
    on_cpu = encode(copy.deepcopy(bert).cpu(), ids, mask)
    enc_err = (on_card - on_cpu).abs().max().item()
    need(enc_err <= 1e-4, f"10: the card's BertEncoder differs from the "
                          f"CPU's by {enc_err:.3g} (limit 1e-4)")

    lm = SentenceLmCascade({"en": sb}, dense, bm25_candidates=100)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sb.precompute_embeddings(dense)
    torch.cuda.synchronize()
    embed_s = time.perf_counter() - t0
    flops = S * seq_len * bert_token_flops(bcfg, seq_len)
    need(tuple(sb.embeddings.shape) == (S, bcfg.dim)
         and bool(torch.isfinite(sb.embeddings).all()),
         f"10: sentence embeddings {tuple(sb.embeddings.shape)} not finite "
         f"or not (S, {bcfg.dim})")
    say(f"[10 sentence cascade] embedding pass: {S} sentences x {seq_len} "
        f"tokens through MiniLM-L12 at f32 in {embed_s:.2f} s -> "
        f"{S / embed_s:.0f} sentences/s, {flops:.3g} FLOP at "
        f"{flops / embed_s / 1e12:.1f} TFLOP/s = "
        f"{flops / PEAK_F32_FLOPS / embed_s:.1%} of the f32 peak (bound "
        f"{flops / PEAK_F32_FLOPS:.1f} s); card vs CPU encoder on 64 "
        f"sentences: max |diff| {enc_err:.3g}")

    dev_q, dev_l = queries.queries[:n_dev], queries.langs[:n_dev]
    ev_q, ev_l = queries.queries[n_dev:], queries.langs[n_dev:]
    ev_p = queries.positive_docs[n_dev:]

    # stage 2 on the card (gather, product, packed pull) against tdr's host
    # einsum (tdr/rank/sentence.py:284-286) on one eval chunk: the stage-1
    # rows of the same chunk, the embeddings pulled whole to the host
    nq = min(lm.query_batch, len(ev_q))
    (chunk,) = lm._run_stages(ev_q[:nq], ev_l[:nq])
    _, _, c_vals, c_valid, c_sims, _ = chunk
    s1_vals, s1_rows = sb.model.topk_tokens(
        lm._tokenize(ev_q, range(nq), "en"), lm.bm25_candidates, pad_to=nq)
    emb = sb.embeddings.cpu().numpy()
    q_emb = dense.encode_queries(ev_q[:nq]).cpu().numpy()
    ref = np.einsum("gmd,gd->gm", emb[np.clip(s1_rows, 0, S - 1)], q_emb)
    del emb
    s2_err = float(np.abs(np.where(c_valid, c_sims - ref, 0.0)).max())
    need(np.array_equal(c_vals, s1_vals) and c_valid.any(),
         "10: the stage-2 chunk's scores are not its stage-1 scores")
    need(s2_err <= 1e-5, f"10: stage-2 similarities differ from the host "
                         f"einsum by {s2_err:.3g} (limit 1e-5)")
    say(f"[10 sentence cascade] stage 2 on {nq} queries x "
        f"{lm.bm25_candidates} candidates against the host einsum: max "
        f"|diff| {s2_err:.3g}")
    t0 = time.perf_counter()
    alpha, curve = lm.tune_fusion_alpha(dev_q, dev_l,
                                        queries.positive_docs[:n_dev], k=10)
    tune_s = time.perf_counter() - t0
    warm = ev_q[:lm.query_batch]
    lm.retrieve(warm, ev_l[:len(warm)], k=10)
    (res, s1), counts = counted(lambda: lm.retrieve(ev_q, ev_l, k=10,
                                                    with_stage1=True))
    need(counts["tail_compact"] > 0,
         f"10: K1 never launched on the sentence path {counts}")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        again = lm.retrieve(ev_q, ev_l, k=10, with_stage1=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        need(again == (res, s1), "10: two retrieve calls gave other lists")
    med = statistics.median(times)
    r_lm = recall_at_k(res, ev_p, 10)
    r_s1 = recall_at_k(s1, ev_p, 10)
    ceiling = recall_at_k(s1, ev_p, max(len(r) for r in s1))
    one = dataclasses.replace(lm, fusion_alpha=1.0, doc_agg_weight=0.0)
    r_one = one.retrieve(ev_q, ev_l, k=10)
    need(r_one == [r[:10] for r in s1]
         and recall_at_k(r_one, ev_p, 10) == r_s1,
         "10: fusing at alpha 1 without doc evidence is not the stage-1 "
         "order")
    say(f"[10 sentence cascade] dev tune {tune_s:.2f} s: alpha "
        f"{alpha} doc_agg {lm.doc_agg_weight} (best dev recall "
        f"{max(curve.values()):.4f}); {len(ev_q)} eval queries: median "
        f"{med:.4f} s of {[round(t, 4) for t in times]} -> "
        f"{len(ev_q) / med:.1f} queries/s; recall@10 LM cascade {r_lm:.4f} "
        f"(random weights: reported only), stage-1 {r_s1:.4f}, candidate "
        f"ceiling {ceiling:.4f}; alpha 1 == stage 1; lists deterministic; "
        f"launches in one pass {counts}")
    if profile:
        profile_pass("sentence embedding, 32 batches of 256",
                     lambda: dense.encode_queries(sb.texts[:32 * 256]))
        profile_pass("sentence cascade", lambda: lm.retrieve(
            ev_q, ev_l, k=10, with_stage1=True))
    check_recall("10 sentence stage-1", r_s1, 0.696)
    need(abs(ceiling - 0.924) <= 0.003 + 1e-9,
         f"10: candidate ceiling {ceiling:.4f} outside 0.924 +- 0.003 (the "
         f"JAX ceiling on this corpus)")
    del lm, one, dense, bert
    sb.embeddings = None
    say(f"phase 10: {time.perf_counter() - t_phase:.1f} s")
    return counts, corpus, queries, sb


def train_flow_phase(corpus, queries, sb, n_dev=200, n_pseudo=4000):
    """11a: the JAX bench's training flow (bench.py:422-507) on phase 10's
    corpus and sentence index: ICT pseudo-queries, hard negatives mined
    through the serving BM25 router (K2 on en's full-vocab head), three
    epochs of ``train_dense_retriever`` at the bench's config, then the
    trained encoder re-ranking the sentence cascade (K1 in stage 1).
    Returns the mined training set and the launches of the two paths."""
    import numpy as np
    import torch
    from tdr_torch.data.loaders import QuerySet
    from tdr_torch.eval import recall_at_k
    from tdr_torch.models.dense import DenseModel
    from tdr_torch.ops.fused_head import fused_head_available
    from tdr_torch.rank import (LanguageRouter, SentenceLmCascade,
                                build_language_models, rrf_fuse)
    from tdr_torch.train import (concat_querysets, make_pseudo_queries,
                                 mine_hard_negatives, train_dense_retriever)
    from tdr_torch.utils.config import DenseConfig

    t_phase = time.perf_counter()
    doc_models = build_language_models(corpus, device=DEVICE)
    ix = doc_models["en"].index
    need(fused_head_available(ix) and ix.n_docs_pad >= 65536,
         f"11a: the en doc index (N {ix.n_docs_pad}, head {ix.head_size} of "
         f"{ix.vocab_size}) does not reach K2")
    router = LanguageRouter(doc_models, query_batch=256)
    build_s = time.perf_counter() - t_phase
    dev_qs = QuerySet(queries.query_ids[:n_dev], queries.queries[:n_dev],
                      queries.langs[:n_dev], queries.positive_docs[:n_dev])
    t0 = time.perf_counter()
    pqs = make_pseudo_queries(corpus, n_pseudo, seed=11)
    pseudo_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mined, mine_counts = counted(lambda: mine_hard_negatives(
        router, concat_querysets([dev_qs, pqs]), n_neg=2, depth=20,
        fallback_docids=corpus.docids, seed=11))
    mine_s = time.perf_counter() - t0
    need(mine_counts["fused_head"] > 0,
         f"11a: K2 never launched while mining {mine_counts}")
    need(all(len(n) == 2 and p not in n for n, p in
             zip(mined.negative_docs, mined.positive_docs)),
         "11a: a mined query lacks two negatives or holds its positive")
    say(f"[11a train flow] doc BM25 build {build_s:.1f} s (en N "
        f"{ix.n_docs_pad}, full-vocab head {ix.head_size}); "
        f"{len(pqs.queries)} pseudo-queries {pseudo_s:.1f} s; mined "
        f"{len(mined.queries)} queries x 2 negatives in {mine_s:.2f} s, "
        f"launches {mine_counts}")

    dcfg = DenseConfig(vocab_size=4000, dim=64, depth=2, heads=4, max_len=32)
    t0 = time.perf_counter()
    model, state, metrics = train_dense_retriever(
        corpus, mined, dcfg, epochs=3, batch_size=50, n_neg=2, lr=1e-3,
        device=DEVICE)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    curve = metrics["loss_curve"]
    need(len(curve) == 3 and np.isfinite(curve).all() and curve[-1] < curve[0],
         f"11a: loss curve {curve} not finite and falling")
    dense = DenseModel.build(model, dcfg, corpus.texts[:1], corpus.docids[:1],
                             batch=32)
    sb.embeddings = None                  # phase 10's BERT embeddings
    lm = SentenceLmCascade({"en": sb}, dense, bm25_candidates=100)
    t0 = time.perf_counter()
    sb.precompute_embeddings(dense)
    torch.cuda.synchronize()
    embed_s = time.perf_counter() - t0
    dev_q, dev_l = queries.queries[:n_dev], queries.langs[:n_dev]
    ev_q, ev_l = queries.queries[n_dev:], queries.langs[n_dev:]
    ev_p = queries.positive_docs[n_dev:]
    alpha, _ = lm.tune_fusion_alpha(dev_q, dev_l,
                                    queries.positive_docs[:n_dev], k=10)
    warm = ev_q[:lm.query_batch]
    lm.retrieve(warm, ev_l[:len(warm)], k=10)
    (res, s1), counts = counted(lambda: lm.retrieve(ev_q, ev_l, k=10,
                                                    with_stage1=True))
    need(counts["tail_compact"] > 0,
         f"11a: K1 never launched on the trained sentence cascade {counts}")
    res_doc = router.retrieve(ev_q, ev_l, k=10)
    r_lm, r_s1 = recall_at_k(res, ev_p, 10), recall_at_k(s1, ev_p, 10)
    r_doc = recall_at_k(res_doc, ev_p, 10)
    r_rrf = recall_at_k(rrf_fuse([res_doc, res], k=10), ev_p, 10)
    say(f"[11a train flow] {state.step} steps (3 epochs of "
        f"{state.step // 3} x 50) in {train_s:.2f} s; loss curve {curve} "
        f"(JAX on a TPU v5e: [3.928, 3.539, 2.069]); sentence embedding "
        f"pass {embed_s:.2f} s; alpha {alpha} doc_agg {lm.doc_agg_weight}; "
        f"recall@10 on {len(ev_q)} eval queries: LM cascade {r_lm:.4f} (JAX "
        f"0.730), stage 1 {r_s1:.4f}, doc BM25 {r_doc:.4f} (JAX 0.768), RRF "
        f"{r_rrf:.4f} (JAX 0.788); launches in one pass {counts}; phase 11a "
        f"{time.perf_counter() - t_phase:.1f} s")
    need(alpha < 1.0, f"11a: the tuned alpha is {alpha}: the trained encoder "
                      f"adds nothing to stage 1")
    need(r_lm > 0.696, f"11a: LM recall@10 {r_lm:.4f} not above the stage-1 "
                       f"0.696")
    check_recall("11a doc-level BM25", r_doc, 0.768)
    del lm, dense, router, doc_models, model, state
    return mined, {"train_mining": mine_counts,
                   "train_sentence_cascade": counts}


def train_step_flops(model, cfg, n_seq: int):
    """(model FLOP of one train step, non-embedding parameters): 6 x the
    non-embedding parameters x the padded tokens (2 a MAC forward, 4
    backward), plus the attention's two (L x L x D) products a layer and
    sequence at 2 FLOP a MAC, three times over (forward and backward)."""
    n = sum(p.numel() for name, p in model.named_parameters()
            if name not in ("tok_embed.weight", "pos_embed"))
    L = cfg.max_len
    return (6.0 * n * n_seq * L + 12.0 * cfg.depth * n_seq * L * L * cfg.dim,
            n)


def _params_differ(a, b) -> float:
    """Largest |difference| of two states' params and AdamW moments."""
    from tdr_torch.train.contrastive import adam_moments

    worst = 0.0
    sa, sb = a.model.state_dict(), b.model.state_dict()
    pairs = [(sa, sb)] + list(zip(adam_moments(a)[1:], adam_moments(b)[1:]))
    for x, y in pairs:
        for k in x:
            worst = max(worst, (x[k] - y[k]).abs().max().item())
    return worst


def train_width_phase(corpus, queries, mined, n_dev=200, cfg=None,
                      profile=False):
    """11b: the same trainer at ``DenseConfig()`` width, one epoch on 11a's
    mined queries with the step timed; the trained encoder's dense
    retrieval over the corpus (K3) against the untrained one's; a
    train-state and a dense-model checkpoint round trip on the card.
    Returns the K3 pass's launches."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from tdr_torch.ckpt import (load_dense_model, load_train_state,
                                save_dense_model, save_train_state)
    from tdr_torch.eval import recall_at_k
    from tdr_torch.models.dense import DenseModel
    from tdr_torch.models.encoder import init_encoder
    from tdr_torch.train import create_train_state, make_train_step
    from tdr_torch.train.contrastive import make_batches
    from tdr_torch.utils.config import DenseConfig

    t_phase = time.perf_counter()
    cfg = cfg or DenseConfig()
    by_id = dict(zip(corpus.docids, corpus.texts))
    t0 = time.perf_counter()
    batches = list(make_batches(mined, by_id, cfg, 50, 2, seed=0))
    batch_s = time.perf_counter() - t0
    state = create_train_state(cfg, lr=1e-3, seed=0, device=DEVICE)
    step_fn = make_train_step()
    n_seq = 4 * 50
    tokens = n_seq * cfg.max_len
    valid = float(np.mean([sum(b[k].sum() for k in ("q_mask", "p_mask",
                                                     "n_mask"))
                           for b in batches]))
    flops, n_params = train_step_flops(state.model, cfg, n_seq)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for b in batches:
        t0 = time.perf_counter()
        state, m = step_fn(state, b)
        losses.append(m["loss"].item())        # waits for the step
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(times)
    q = max(1, len(losses) // 4)
    first, last = float(np.mean(losses[:q])), float(np.mean(losses[-q:]))
    need(np.isfinite(losses).all() and last < first,
         f"11b: losses not finite and falling (first quarter {first:.4f}, "
         f"last {last:.4f})")
    say(f"[11b train width] dim {cfg.dim} depth {cfg.depth} heads "
        f"{cfg.heads} vocab {cfg.vocab_size} max_len {cfg.max_len} "
        f"{cfg.dtype}: {len(batches)} steps of {n_seq} sequences "
        f"({tokens} padded tokens, {valid:.0f} valid; batches built in "
        f"{batch_s:.2f} s on the host); step median {med * 1e3:.2f} ms "
        f"(min {min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}) -> "
        f"{tokens / med:.0f} tokens/s; {flops:.4g} model FLOP a step "
        f"(6 x {n_params} non-embedding params x tokens + attention) = "
        f"{flops / med / 1e12:.1f} TFLOP/s, {flops / med / PEAK_BF16_FLOPS:.1%} "
        f"of the bf16 dense peak; peak memory {peak / 2**30:.2f} GiB; loss "
        f"first quarter {first:.4f} -> last quarter {last:.4f} "
        f"({losses[0]:.4f} -> {losses[-1]:.4f})")
    if profile:
        profile_pass("train step x4", lambda: [step_fn(state, b)
                                               for b in batches[:4]])

    ev_q, ev_p = queries.queries[n_dev:], queries.positive_docs[n_dev:]
    t0 = time.perf_counter()
    trained = DenseModel.build(state.model, cfg, corpus.texts, corpus.docids,
                               batch=256)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    res, counts = counted(lambda: trained.retrieve(ev_q, k=10))
    need(counts["fused_flat"] > 0,
         f"11b: K3 never launched on the trained dense pass {counts}")
    untrained = DenseModel.build(init_encoder(cfg, seed=0, device=DEVICE), cfg,
                                 corpus.texts, corpus.docids, batch=256)
    r_t = recall_at_k(res, ev_p, 10)
    r_u = recall_at_k(untrained.retrieve(ev_q, k=10), ev_p, 10)
    del untrained
    say(f"[11b train width] dense build over {len(corpus.texts)} docs "
        f"{build_s:.1f} s; recall@10 on {len(ev_q)} eval queries: trained "
        f"{r_t:.4f}, untrained init_encoder(seed=0) {r_u:.4f}; launches in "
        f"one pass {counts}")

    # checkpoints: resume equals straight training, within the card's own
    # run-to-run difference (0 when its step is deterministic)
    tmp = tempfile.mkdtemp(prefix="tdr_train_")
    try:
        def run(seed, bs, st=None):
            st = st or create_train_state(cfg, lr=1e-3, seed=seed,
                                          device=DEVICE)
            for b in bs:
                st, _ = step_fn(st, b)
            return st

        straight = run(1, batches[:4])
        spread = _params_differ(straight, run(1, batches[:4]))
        save_train_state(os.path.join(tmp, "train"), run(1, batches[:2]))
        resumed = load_train_state(os.path.join(tmp, "train"),
                                   create_train_state(cfg, lr=1e-3, seed=2,
                                                      device=DEVICE))
        resumed = run(0, batches[2:4], resumed)
        gap = _params_differ(straight, resumed)
        need(resumed.step == 4 and gap <= spread,
             f"11b: 2 steps + save + load + 2 steps differ from 4 straight "
             f"steps by {gap:.3g} (two straight runs: {spread:.3g})")
        del straight, resumed
        save_dense_model(os.path.join(tmp, "dense"), trained)
        loaded = load_dense_model(os.path.join(tmp, "dense"), device=DEVICE)
        need(loaded.retrieve(ev_q, k=10) == res,
             "11b: the loaded dense model's lists differ from the built one's")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say(f"[11b train width] train state: 2 + save/load + 2 steps == 4 "
        f"straight (max |diff| {gap:.3g}; two straight runs {spread:.3g}); "
        f"dense model save/load: lists equal; phase 11b "
        f"{time.perf_counter() - t_phase:.1f} s")
    del trained, loaded, state
    return counts


def train_tf32_phase(corpus, mined):
    """11c: one f32 train step at a small width, on the card with the TF32
    flag off and on (the params must agree to 1e-6 and the flag read back
    as set) and on the CPU from the same weights and batch: the gradients
    within the CPU test's 1e-5 (tests/test_torch_train.py), the params
    within 3e-5 beyond what Adam's normalization makes of the gradient
    difference."""
    import torch
    from tdr_torch.train import create_train_state, make_train_step
    from tdr_torch.train.contrastive import make_batches
    from tdr_torch.utils.config import DenseConfig

    cfg = DenseConfig(vocab_size=4000, dim=128, depth=2, heads=4, max_len=32,
                      dtype="float32")
    lr = 1e-3
    batch = next(make_batches(mined, dict(zip(corpus.docids, corpus.texts)),
                              cfg, 50, 2, seed=3))

    def one(device, tf32):
        st = create_train_state(cfg, lr=lr, seed=5, device=device)
        before = torch.get_float32_matmul_precision()
        try:
            if tf32:
                torch.set_float32_matmul_precision("high")
            make_train_step()(st, batch)
            flag = torch.get_float32_matmul_precision()
        finally:
            torch.set_float32_matmul_precision(before)
        return ({k: p.detach().cpu() for k, p in st.model.named_parameters()},
                {k: p.grad.cpu() for k, p in st.model.named_parameters()},
                flag)

    off, g_off, _ = one(DEVICE, False)
    on, _, flag = one(DEVICE, True)
    cpu, g_cpu, _ = one("cpu", False)
    need(flag == "high", f"11c: the TF32 flag read back as {flag!r}")
    tf32_gap = max((off[k] - on[k]).abs().max().item() for k in off)
    need(tf32_gap <= 1e-6, f"11c: the f32 step with TF32 on differs by "
                           f"{tf32_gap:.3g} (limit 1e-6)")
    top = max(g.abs().max().item() for g in g_cpu.values())
    worst_g = worst_p = worst_excess = 0.0
    for k in off:
        g, r = g_off[k], g_cpu[k]
        if k.endswith("attn.key.bias"):
            # true gradient zero (softmax shift): rounding noise both sides
            need(g.abs().max().item() <= 1e-6 * top
                 and r.abs().max().item() <= 1e-6 * top,
                 f"11c: key-bias gradient {k} is not rounding noise")
        else:
            gerr = (g - r).abs() / (1e-5 * r.abs().max() + 1e-5 * r.abs())
            worst_g = max(worst_g, gerr.max().item())
        # Adam's first step moves a param by lr * g / (|g| + eps): where |g|
        # is near eps (1e-8) it turns a gradient difference well inside the
        # limit above into a step difference of up to 2 lr
        amp = lr * (g / (g.abs() + 1e-8) - r / (r.abs() + 1e-8)).abs()
        d = (off[k] - cpu[k]).abs()
        worst_p = max(worst_p, d.max().item())
        worst_excess = max(worst_excess, (d - amp).max().item())
    need(worst_g <= 1.0, f"11c: card gradients differ from the CPU's beyond "
                         f"1e-5 ({worst_g:.3g} of the limit)")
    need(worst_excess <= 3e-5,
         f"11c: card params differ from the CPU's by {worst_excess:.3g} "
         f"beyond Adam's amplification of the gradient difference (limit "
         f"3e-5)")
    say(f"[11c train f32] one step at dim {cfg.dim} depth {cfg.depth}: TF32 "
        f"on vs off max |diff| {tf32_gap:.3g} (flag read back {flag!r}); "
        f"card vs CPU: gradients at {worst_g:.3g} of the 1e-5 limit, params "
        f"max |diff| {worst_p:.3g}, {worst_excess:.3g} beyond Adam's "
        f"amplification of the gradient difference (limit 3e-5)")


def _pin_signs(doc_emb, Vt):
    """Each SVD component's sign fixed so that its largest |Vt| entry is
    positive (sklearn's ``svd_flip`` on V)."""
    import numpy as np

    s = np.sign(Vt[np.arange(Vt.shape[0]), np.abs(Vt).argmax(axis=1)])
    return doc_emb * s[None, :], Vt * s[:, None]


def extras_phase(corpus, lang="ar", rank=256):
    """11d: ``tfidf_svd`` at the reference's TruncatedSVD width on a TF-IDF
    index of the phase-2 corpus's ``lang`` documents, card against CPU from
    one start matrix; ``LogisticRegressionRanker`` and
    ``UnigramLanguageModel`` card against CPU."""
    import numpy as np
    import torch
    from tdr_torch.data.loaders import Corpus
    from tdr_torch.models import TfidfCosineModel
    from tdr_torch.models.extras import (LogisticRegressionRanker,
                                         UnigramLanguageModel)
    from tdr_torch.ops.svd import l2_normalize, project_queries, tfidf_svd
    from tdr_torch.rank import build_language_models

    t_phase = time.perf_counter()
    pick = [i for i, l in enumerate(corpus.langs) if l == lang]
    sub = Corpus([corpus.docids[i] for i in pick],
                 [corpus.texts[i] for i in pick], [lang] * len(pick))
    ix = build_language_models(sub, model_cls=TfidfCosineModel,
                               device=DEVICE)[lang].index
    r = min(rank + 16, ix.vocab_size, ix.n_docs_pad)
    nnz = int(ix.indptr[-1])
    say(f"[11d svd] {lang}: {len(pick)} docs (pad {ix.n_docs_pad}), vocab "
        f"pad {ix.vocab_size}, nnz {nnz}: each scatter product builds "
        f"{ix.postings_w.shape[0] * r * 4 / 1e9:.2f} GB")
    G = torch.randn((ix.vocab_size, r),
                    generator=torch.Generator().manual_seed(0))
    out = {}
    for dev, index in ((DEVICE, ix), ("cpu", ix.to("cpu"))):
        t0 = time.perf_counter()
        res = tfidf_svd(index, G, rank=rank)
        if dev != "cpu":
            torch.cuda.synchronize()
        out[dev] = ([t.cpu().numpy() for t in res], time.perf_counter() - t0)
    (ce, cS, cV), card_s = out[DEVICE]
    (he, hS, hV), cpu_s = out["cpu"]
    need(np.isfinite(ce).all() and ce.shape == (ix.n_docs_pad, rank),
         f"11d: doc coordinates {ce.shape} not finite or not (N, {rank})")
    s_err = float(np.abs(cS - hS).max() / hS[0])
    need(np.allclose(cS, hS, rtol=1e-4, atol=1e-6 * hS[0]),
         f"11d: singular values differ by {s_err:.3g} of the largest")
    ce, cV = _pin_signs(ce, cV)
    he, hV = _pin_signs(he, hV)
    # f32 sums in another order (atomics over the postings) perturb B by
    # about 1e-7 of S[0]; a component's vectors move by that over its gap to
    # the next value (Davis-Kahan), so they are held where the gaps are at
    # least 1e-2 of S[0], and so is the reconstruction's cut
    sep = 1e-2 * hS[0]
    gap = np.full(hS.shape, np.inf)
    d = np.abs(np.diff(hS))
    gap[:-1] = np.minimum(gap[:-1], d)
    gap[1:] = np.minimum(gap[1:], d)
    ok = gap > sep
    cut = max([k + 1 for k in range(rank - 1) if hS[k] - hS[k + 1] > sep]
              or [1])
    need(ok.any(), "11d: no singular value stands clear of its neighbours")
    v_err = float(np.abs(cV[ok] - hV[ok]).max() / np.abs(hV).max())
    e_err = float(np.abs(ce[:, ok] - he[:, ok]).max() / np.abs(he).max())
    rec_c, rec_h = ce[:, :cut] @ cV[:cut], he[:, :cut] @ hV[:cut]
    r_err = float(np.abs(rec_c - rec_h).max() / np.abs(rec_h).max())
    need(v_err <= 1e-4 and e_err <= 1e-4 and r_err <= 1e-4,
         f"11d: card vs CPU SVD (signs pinned): Vt {v_err:.3g}, doc "
         f"coordinates {e_err:.3g}, rank-{cut} reconstruction {r_err:.3g} of "
         f"their scale (limit 1e-4)")
    # project_queries on the card against the CPU, through one Vt
    qids = np.random.RandomState(0).randint(0, ix.vocab_size, (256, 8))
    qw = np.random.RandomState(1).rand(256, 8).astype(np.float32)
    pq_c = l2_normalize(project_queries(torch.as_tensor(hV, device=DEVICE),
                                        qids, qw)).cpu().numpy()
    pq_h = l2_normalize(project_queries(torch.from_numpy(hV), qids,
                                        qw)).numpy()
    need(np.abs(pq_c - pq_h).max() <= 1e-5,
         "11d: projected queries differ between card and CPU")
    say(f"[11d svd] rank {rank} (+16 oversample, 2 power iterations): card "
        f"{card_s:.2f} s, CPU {cpu_s:.2f} s; S[0] {hS[0]:.4f} S[-1] "
        f"{hS[-1]:.4f}; card vs CPU (signs pinned): S {s_err:.3g}, Vt "
        f"{v_err:.3g} and doc coordinates {e_err:.3g} on {int(ok.sum())} "
        f"components with gaps over 1e-2 S[0], rank-{cut} reconstruction "
        f"{r_err:.3g}")

    rng = np.random.RandomState(2)
    X = rng.randn(4096, 64).astype(np.float32)
    y = (X @ rng.randn(64) + 0.5 * rng.randn(4096) > 0).astype(np.float32)
    t0 = time.perf_counter()
    card = LogisticRegressionRanker(device=DEVICE).fit(X, y)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    host = LogisticRegressionRanker(device="cpu").fit(X, y)
    need(np.allclose(card.w.cpu().numpy(), host.w.numpy(), rtol=1e-5,
                     atol=1e-6) and abs(card.b.item() - host.b.item())
         <= 1e-5 * abs(host.b.item()) + 1e-6,
         "11d: the card's logistic ranker differs from the CPU's")
    pc, ph = card.predict_proba(X), host.predict_proba(X)
    need(np.allclose(pc, ph, rtol=1e-5, atol=1e-7),
         "11d: logistic probabilities differ between card and CPU")
    top_c, top_h = card.rank(X, k=10), host.rank(X, k=11)
    need(same_ranking(top_c, pc[top_c], top_h, ph[top_h], rtol=1e-5,
                      atol=1e-7), "11d: logistic top-10 differs")
    lm_c = UnigramLanguageModel.from_index(ix)
    lm_h = UnigramLanguageModel.from_index(ix.to("cpu"))
    lc, lh = lm_c.log_prob.cpu().numpy(), lm_h.log_prob.numpy()
    need(np.abs(lc - lh).max() <= 2 * np.spacing(np.abs(lh)).max(),
         "11d: unigram log-probabilities differ by more than 2 ulps")
    sc, sh = lm_c.score_queries(qids, qw), lm_h.score_queries(qids, qw)
    need(np.allclose(sc, sh, rtol=1e-6, atol=1e-5),
         "11d: unigram query scores differ between card and CPU")
    say(f"[11d extras] logistic ranker (1000 epochs, lr 0.01, 4096 x 64) "
        f"card {fit_s:.2f} s, == CPU within rtol 1e-5; unigram LM over "
        f"{nnz} postings == CPU within 2 ulps; phase 11d "
        f"{time.perf_counter() - t_phase:.1f} s")


def checkpoint_phase(models, queries):
    """8f: save_registry / load_registry of the seven models; the loaded
    router's top-10 equals the built one's."""
    import shutil
    import tempfile

    import numpy as np
    from tdr_torch.ckpt import load_registry, save_registry
    from tdr_torch.rank import LanguageRouter

    tmp = tempfile.mkdtemp(prefix="tdr_ckpt_")
    try:
        t0 = time.perf_counter()
        save_registry(tmp, models)
        t_save = time.perf_counter() - t0
        n_bytes = sum(os.path.getsize(os.path.join(d, f))
                      for d, _, fs in os.walk(tmp) for f in fs)
        t0 = time.perf_counter()
        loaded = load_registry(tmp, device=DEVICE)
        t_load = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    qs, langs = queries.queries, queries.langs
    a_docs, a_scores = LanguageRouter(models, query_batch=256) \
        .retrieve_with_scores(qs, langs, k=10)
    b_docs, b_scores = LanguageRouter(loaded, query_batch=256) \
        .retrieve_with_scores(qs, langs, k=10)
    need(a_docs == b_docs and np.array_equal(a_scores, b_scores),
         "the loaded registry's top-10 differs from the built one's")
    say(f"[8f checkpoints] {len(models)} models: {n_bytes / 1e9:.3f} GB "
        f"written in {t_save:.2f} s, loaded in {t_load:.2f} s; the loaded "
        f"router's top-10 lists and scores equal the built one's")


def single_query_latency(router, queries, lang, n=64):
    """Phase 5: ``n`` single ``lang`` queries through the router, one at a
    time (K1 on each: a tail language), host clock around each with a
    synchronize; the median ms a query."""
    import torch

    qs = [q for q, l in zip(queries.queries, queries.langs) if l == lang][:n]
    for q in qs[:4]:
        router.retrieve([q], [lang], k=10)
    times = []
    for q in qs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        router.retrieve([q], [lang], k=10)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    say(f"[single {lang}] {len(qs)} queries one at a time: median "
        f"{statistics.median(times):.3f} ms a query (min {min(times):.3f}, "
        f"max {max(times):.3f})")
    return statistics.median(times)


def tf32_phase(f32_models, f32_ref, flat, q_enc, bench_emb, bench_q,
               strict=True):
    """9c: four f32 checks again, with TF32 turned on the way a user would
    (``torch.set_float32_matmul_precision("high")``), at the tolerances they
    use without it: K2 f32 at en Q = 256 (``check_fused_head_f32``); K3 f32
    at the bench shape, ip and l2 (``check_fused_flat``); the f32-head pass
    against 9a's scatter-path lists (taken with the flag off); the f32 dense
    copy against ``flat_search(engine="plain")``.  After each port call the
    flag must read back as the caller set it; at the end it is restored.
    Each check gets its own verdict; with ``strict`` the phase fails at the
    end if any check failed.  Returns the failed checks' labels."""
    import numpy as np
    import torch
    from tdr_torch.models.dense import flat_search
    from tdr_torch.rank import LanguageRouter
    from tdr_torch.text.fast import fast_tokenize_texts

    failed, n_checks = [], 0

    def verdict(label, run):
        nonlocal n_checks
        n_checks += 1
        try:
            run()
            need(torch.get_float32_matmul_precision() == "high"
                 and torch.backends.cuda.matmul.allow_tf32,
                 f"9c: the TF32 flag was not restored after {label}")
            say(f"[9c TF32 on] {label}: held; the flag read back \"high\"")
        except SystemExit:
            failed.append(label)
            say(f"[9c TF32 on] {label}: FAILED (the reason is on stderr)")

    def heads_pass():
        router = LanguageRouter(f32_models, query_batch=256)
        docs, scores = router.retrieve_with_scores(f32_ref["queries"],
                                                   f32_ref["langs"], k=10)
        bad = lists_match(docs, scores, *f32_ref["lists"])
        need(not bad, f"9c: with TF32 on, the f32-head pass differs from the "
                      f"scatter path's lists (TF32 off) at {len(bad)} of "
                      f"{len(docs)} queries, {bad[:10]}")

    def dense_pass():
        f32 = dataclasses.replace(flat, embeddings=flat.embeddings.float())
        fv, fr = flat_search(f32, q_enc, 10)
        # 20 deep, as in check_fused_flat
        pv, pr = flat_search(f32, q_enc, 20, engine="plain")
        fv, fr, pv, pr = (t.cpu().numpy() for t in (fv, fr, pv, pr))
        need(bool(np.isfinite(fv).all()), "9c: non-finite dense scores")
        bad = lists_match(fr, fv, pr, pv, atol=1e-5)
        need(not bad, f"9c: with TF32 on, the f32 dense search differs from "
                      f"the plain engine at {len(bad)} of {fr.shape[0]} "
                      f"queries (max |score difference| "
                      f"{np.abs(fv - pv[:, :10]).max():.3e}), {bad[:10]}")

    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        en = f32_models["en"]
        qs = [q for q, l in zip(f32_ref["queries"], f32_ref["langs"])
              if l == "en"][:256]
        qids, qw = en.encode_query_tokens(fast_tokenize_texts(qs, "en"))
        verdict("K2 f32 en Q=256", lambda: check_fused_head_f32(
            en.index, [(qids, qw, "9c TF32 on, en Q=256", None)]))
        bq = torch.as_tensor(bench_q, device=DEVICE)
        for metric in ("ip", "l2"):
            index = flat_index_on_card(bench_emb, metric, "float32")
            verdict(f"K3 f32 {metric}", lambda: check_fused_flat(
                index, bq, f"9c TF32 on, float32 {metric}"))
            del index
        verdict("the f32-head pass against the scatter lists", heads_pass)
        verdict("the f32 dense search against the plain engine", dense_pass)
    finally:
        torch.set_float32_matmul_precision(before)
    say(f"[9c TF32 on] {n_checks - len(failed)} of {n_checks} checks held "
        f"with set_float32_matmul_precision(\"high\"); restored to "
        f"{before!r}")
    if strict and failed:
        fail(f"9c: with TF32 on, {failed} failed")
    return failed


def profile_pass(label, run, trace_out=None) -> None:
    """One pass (``run()``) under torch.profiler: device time by kernel
    name, and the share of the pass's wall time the device was busy (union
    of kernel intervals).  With ``trace_out`` the Chrome trace is written
    there."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
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
    say(f"[profile {label}] pass wall {wall * 1e3:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms ({100 * busy / 1e3 / (wall * 1e3):.1f}%), "
        f"{len(spans)} device events")
    rows = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = getattr(e, "cuda_time_total", 0)
        if t > 0 and e.device_type.name == "CUDA":
            rows[e.key] = (t, e.count)
    ranked = sorted(rows.items(), key=lambda kv: -kv[1][0])
    # the top 15, and the port's own kernels wherever they rank
    ours = ("tail_compact", "fused_head", "fused_flat", "head_scores")
    for rank, (key, (t, n)) in enumerate(ranked):
        if rank < 15 or any(k in key for k in ours):
            say(f"[profile {label}]   {t / 1e3:10.3f} ms  x{n:<5d} "
                f"{key[:90]}")
    # the same device time by the torch operator that launched it
    ops = [(e.self_device_time_total, e.count, e.key)
           for e in prof.key_averages()
           if e.device_type.name == "CPU"
           and getattr(e, "self_device_time_total", 0) > 0]
    for t, n, key in sorted(ops, reverse=True)[:12]:
        say(f"[profile {label} op] {t / 1e3:10.3f} ms  x{n:<5d} {key}")
    if trace_out:
        os.makedirs(os.path.dirname(os.path.abspath(trace_out)), exist_ok=True)
        prof.export_chrome_trace(trace_out)


# -- phase 12: the parallel serving layer ------------------------------------

def coo_from_index(index):
    """The COO (doc_ids, term_ids, tfs, doc_lens) a ``SparseIndex`` was built
    from, read back from its CSR: term-major, docs ascending within a term,
    which is the order the build's stable sort by term gives anyway.  Doc
    lengths come back as f64 so that their sum (avgdl) is the build's."""
    import torch

    nnz = int(index.indptr[-1].item())
    lens = (index.indptr[1:] - index.indptr[:-1]).long()
    terms = torch.repeat_interleave(
        torch.arange(lens.numel(), device=lens.device, dtype=torch.int32),
        lens)
    return (index.postings_doc[:nnz].cpu().numpy(), terms.cpu().numpy(),
            index.postings_tf[:nnz].cpu().numpy(),
            index.stats.doc_len[:index.n_docs].double().cpu().numpy())


def hold_lists(label, vals, docs, ref_vals, ref_docs, rtol, atol):
    """Scores within (rtol, atol) of the reference's, where both are
    finite, and lists equal but for near-ties (``same_ranking``).  Returns
    the rank slots that differ."""
    import numpy as np

    vals, ref_vals = np.asarray(vals), np.asarray(ref_vals)
    fin = np.isfinite(ref_vals)
    need(np.array_equal(np.isfinite(vals), fin),
         f"{label}: finite entries differ from the reference")
    if not np.allclose(vals[fin], ref_vals[fin], rtol=rtol, atol=atol):
        err = float(np.max(np.abs(vals[fin] - ref_vals[fin])))
        fail(f"{label}: scores differ from the reference by {err:.3g} "
             f"(rtol {rtol}, atol {atol})")
    bad = [q for q in range(len(docs)) if not same_ranking(
        list(docs[q]), vals[q], list(ref_docs[q]), ref_vals[q])]
    need(not bad, f"{label}: lists differ beyond near-ties at queries "
                  f"{bad[:10]}")
    return int((np.asarray(docs) != np.asarray(ref_docs)).sum())


def parallel_doc_phase(models, queries, full_docs, full_scores, mesh, reps):
    """12a: the seven languages as doc-sharded ``ShardedBM25Model``s (S = 4)
    in one ``LanguageRouter`` over all queries; recall and lists against
    phase 4-5's router.  Returns (the sharded models, launch counts)."""
    import torch
    from tdr_torch.eval import recall_at_k
    from tdr_torch.parallel.sharded import ShardedBM25Model
    from tdr_torch.rank import LanguageRouter

    t0 = time.perf_counter()
    sharded = {}
    for lang, m in sorted(models.items()):
        sharded[lang] = ShardedBM25Model.from_coo(
            m.vocab, coo_from_index(m.index), m.docids, mesh, lang=lang,
            head_size=m.index.head_size)
        sx = sharded[lang].sindex
        need(torch.equal(sx.head_slot, m.index.head_slot),
             f"12a {lang}: the sharded head/tail split differs from the "
             f"single-device index's")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    for lang, sm in sorted(sharded.items()):
        sx = sm.sindex
        head = sx.shards[0].head_rows
        say(f"  [12a {lang}] {sx.n_shards} shards of "
            f"{sx.n_valid.tolist()} docs (pad {sx.n_docs_pad_local}); head "
            f"{tuple(head.shape)} {head.dtype} "
            f"({head.numel() * head.element_size() / 2**30:.3f} GiB a shard); "
            f"tail_pmax {sx.tail_pmax}")
    router = LanguageRouter(sharded, query_batch=256)
    run = lambda: router.retrieve_with_scores(  # noqa: E731
        queries.queries, queries.langs, k=10)
    run()
    (docs, scores), counts = counted(run)
    need(counts["tail_compact"] > 0, f"12a: K1 never ran {counts}")
    med, times = timed(lambda: router.retrieve(queries.queries, queries.langs,
                                               k=10), reps)
    recall = recall_at_k(docs, queries.positive_docs, 10)
    bad = lists_match(docs, scores, full_docs, full_scores)
    need(not bad, f"12a: lists differ from phase 4's router at queries "
                  f"{bad[:10]}")
    n = len(queries.queries)
    say(f"[12a doc-sharded] build {build_s:.1f} s; {n} queries: median "
        f"{med:.4f} s of {[round(t, 4) for t in times]} -> {n / med:.1f} "
        f"queries/s; recall@10 {recall:.4f}; launches in one pass {counts}; "
        f"lists == phase 4's router but near-ties")
    check_recall("12a", recall, 0.7650)
    return sharded, counts


def parallel_grid_dp_phase(models, batch, devices):
    """12b: ``grid_score_topk`` (en, 2 x 2) and ``dp_score_topk`` (es, 4
    ways) against the single-device ``score_and_topk`` on a 256-query
    batch.  Returns the grid's launch counts."""
    import numpy as np
    import torch
    from tdr_torch.ops.score import score_and_topk
    from tdr_torch.parallel import (build_sharded_index, dp_score_topk,
                                    grid_score_topk, make_mesh)
    from tdr_torch.parallel.sharded import global_row_to_doc

    grid = make_mesh(data=2, model=2, devices=devices)
    m = models["en"]
    sx = build_sharded_index(*coo_from_index(m.index), m.vocab.size,
                             n_shards=2, head_size=m.index.head_size,
                             devices=grid.axis_devices("model"))
    qids, qw = batch("en", 256)
    (gv, gr), counts = counted(lambda: grid_score_topk(grid, sx, qids, qw, 10))
    gms = time_ms(lambda: grid_score_topk(grid, sx, qids, qw, 10), 5, 1)
    rv, rr = score_and_topk(m.index, qids, qw, 10)
    swaps = hold_lists("12b grid", gv.cpu().numpy(),
                       global_row_to_doc(sx, gr).cpu().numpy(),
                       rv.cpu().numpy(), rr.cpu().numpy(), 1e-4, 1e-5)
    say(f"[12b grid] en over 2 x 2 (2 shards of {sx.n_valid.tolist()} docs, "
        f"pad {sx.n_docs_pad_local}), Q=256: {gms:.3f} ms a batch; == "
        f"single-device score_and_topk ({swaps} rank slots inside "
        f"near-ties); launches {counts}")
    del sx

    dp = make_mesh(data=4, devices=devices)
    es = models["es"].index
    qids, qw = batch("es", 256)
    dv, dr = dp_score_topk(dp, es, qids, qw, 10)
    dms = time_ms(lambda: dp_score_topk(dp, es, qids, qw, 10), 5, 1)
    rv, rr = score_and_topk(es, qids, qw, 10)
    swaps = hold_lists("12b dp", dv.cpu().numpy(), dr.cpu().numpy(),
                       rv.cpu().numpy(), rr.cpu().numpy(), 1e-5, 1e-6)
    say(f"[12b dp] es Q=256 split 4 ways: {dms:.3f} ms a batch; == "
        f"single-device score_and_topk ({swaps} rank slots inside near-ties)")
    return counts


def parallel_vocab_tp_phase(models, queries, batch, devices):
    """12c: en's full-vocab head slot-sharded 4 ways (pure TP); es as the
    hybrid (sharded head + replicated tail, K1), on its bf16 and on an int8
    head, and one batch over the tail budget (``exact_tail``); each against
    the single-device fused engine on the same batches.  Returns the
    hybrid pass's launch counts."""
    import torch
    from tdr_torch.index.build import quantize_head
    from tdr_torch.ops.score import score_and_topk_fused
    from tdr_torch.parallel import make_mesh
    from tdr_torch.parallel.vocab_tp import (vocab_shard_index,
                                             vocab_shard_layout,
                                             vocab_tp_score_topk)

    tp = make_mesh(data=1, model=4, devices=devices)

    def batches(lang):
        n = sum(1 for l in queries.langs if l == lang)
        return [batch(lang, min(256, n - s), s) for s in range(0, n, 256)]

    def check(label, vix, index, bs, tol, single=None):
        run = lambda: [vocab_tp_score_topk(tp, vix, q, w, 10)  # noqa: E731
                       for q, w in bs]
        got, counts = counted(run)
        ms = time_ms(run, 3, 1) / len(bs)
        swaps = 0
        for (q, w), (tv, tr) in zip(bs, got):
            rv, rr = (single(q, w) if single else score_and_topk_fused(
                index, q, w, top_k=10))
            swaps += hold_lists(f"12c {label}", tv.cpu().numpy(),
                                tr.cpu().numpy(), rv.cpu().numpy(),
                                rr.cpu().numpy(), tol, tol)
        lay, mat = vocab_shard_layout(index, 4), vix.per_device_bytes()
        need(all(lay[k] == mat[k] for k in mat),
             f"12c {label}: per_device_bytes {mat} != layout {lay}")
        say(f"[12c {label}] {len(bs)} batches of {bs[0][0].shape[0]}: "
            f"{ms:.3f} ms a batch; == single-device fused engine ({swaps} "
            f"rank slots inside near-ties); launches {counts}; "
            f"per_device_bytes {mat}; vocab_shard_layout {lay}")
        return counts

    en = models["en"]
    need(en.index.head_size >= en.index.vocab_size,
         "12c: en's head is not full-vocab")
    check("en pure TP", vocab_shard_index(en.index, 4, devices), en.index,
          batches("en"), 1e-5, en.topk_encoded_async)
    es = models["es"]
    es_b = batches("es")
    counts = check("es hybrid", vocab_shard_index(es.index, 4, devices),
                   es.index, es_b, 1e-5, es.topk_encoded_async)
    need(counts["tail_compact"] > 0, f"12c: K1 never ran {counts}")
    es8 = quantize_head(es.index)
    check("es hybrid int8", vocab_shard_index(es8, 4, devices), es8, es_b,
          1e-4)
    del es8
    # row 0: 20 tail terms, over the compaction's 16
    ix = es.index
    tail = torch.nonzero((ix.head_slot < 0) & (ix.stats.df > 0))[:20, 0]
    qids, qw = (t.clone() for t in es_b[0])
    qids[0], qw[0] = 0, 0.0
    qids[0, :20], qw[0, :20] = tail.to(qids.dtype), 1.0
    check("es hybrid overflow batch (exact_tail)",
          vocab_shard_index(ix, 4, devices), ix, [(qids, qw)], 1e-5,
          es.topk_encoded_async)
    return counts


def parallel_dense_phase(flat, q_enc, bench_emb, bench_q, devices, reps):
    """12d: phase 7's dense index over 4 shards against ``flat_search`` (K3)
    on the 2000 encoded queries; l2 and int8 at the bench shape; Rocchio
    feedback against ``flat_search_prf``.  Returns the search's counts."""
    import numpy as np
    import torch
    from tdr_torch.models.dense import flat_search, flat_search_prf
    from tdr_torch.parallel import (build_sharded_flat_index, make_mesh,
                                    sharded_flat_search,
                                    sharded_flat_search_prf,
                                    sharded_row_to_doc)

    mesh = make_mesh(data=4, devices=devices)
    sf = build_sharded_flat_index(flat.embeddings[:flat.n_docs], 4,
                                  devices=devices)
    (sv, sr), counts = counted(lambda: sharded_flat_search(mesh, sf, q_enc, 10))
    med, times = timed(lambda: sharded_flat_search(mesh, sf, q_enc, 10), reps)
    rv, rr = flat_search(flat, q_enc, 10)
    swaps = hold_lists("12d ip bf16", sv.cpu().numpy(),
                       sharded_row_to_doc(sf, sr).cpu().numpy(),
                       rv.cpu().numpy(), rr.cpu().numpy(), 1e-5, 1e-6)
    n = q_enc.shape[0]
    say(f"[12d dense] {flat.n_docs} x {flat.embeddings.shape[1]} bf16 over 4 "
        f"shards of {sf.n_valid.tolist()} rows (pad {sf.n_loc_pad}): {n} "
        f"queries, search median {med * 1e3:.3f} ms of "
        f"{[round(t * 1e3, 3) for t in times]} -> {n / med:.1f} queries/s "
        f"(flat_search, K3, in this process: "
        f"{time_ms(lambda: flat_search(flat, q_enc, 10), reps, 1):.3f} ms); "
        f"== flat_search ({swaps} rank slots inside near-ties); launches "
        f"{counts}")
    del sf

    bq = torch.as_tensor(bench_q, device=DEVICE)
    for metric, dtype, tol in (("l2", "bfloat16", (1e-4, 1e-4)),
                               ("ip", "int8", (1e-5, 1e-6))):
        sf = build_sharded_flat_index(bench_emb, 4, metric=metric,
                                      dtype=dtype, devices=devices)
        one = flat_index_on_card(bench_emb, metric, dtype)
        sv, sr = sharded_flat_search(mesh, sf, bq, 10)
        rv, rr = flat_search(one, bq, 10)
        ms = time_ms(lambda: sharded_flat_search(mesh, sf, bq, 10), 5, 1)
        swaps = hold_lists(f"12d {metric} {dtype}", sv.cpu().numpy(),
                           sharded_row_to_doc(sf, sr).cpu().numpy(),
                           rv.cpu().numpy(), rr.cpu().numpy(), *tol)
        say(f"[12d dense {metric} {dtype}] {bench_emb.shape[0]} x "
            f"{bench_emb.shape[1]}, Q={bq.shape[0]}: {ms:.3f} ms; "
            f"== flat_search ({swaps} rank slots inside near-ties)")
        del sf, one

    # feedback: a query whose first-pass F docs differ inside a near-tie
    # pulls toward another centroid; such queries are shown to be near-ties
    # at the first pass and left out of the second
    sf = build_sharded_flat_index(bench_emb, 4, devices=devices)
    one = flat_index_on_card(bench_emb, "ip", "bfloat16")
    F = 5
    fv, fr = sharded_flat_search(mesh, sf, bq, F)
    f1v, f1r = flat_search(one, bq, F)
    fr = sharded_row_to_doc(sf, fr).cpu().numpy()
    f1v, f1r, fv = f1v.cpu().numpy(), f1r.cpu().numpy(), fv.cpu().numpy()
    skip = [q for q in range(len(fr)) if set(fr[q]) != set(f1r[q])]
    for q in skip:
        need(same_ranking(list(fr[q]), fv[q], list(f1r[q]), f1v[q]),
             f"12d prf: query {q}'s feedback docs differ beyond a near-tie")
    sv, sr = sharded_flat_search_prf(mesh, sf, bq, 10, n_feedback=F, alpha=0.6)
    rv, rr = flat_search_prf(one, bq, 10, n_feedback=F, alpha=0.6)
    keep = [q for q in range(len(fr)) if q not in skip]
    swaps = hold_lists("12d prf", sv.cpu().numpy()[keep],
                       sharded_row_to_doc(sf, sr).cpu().numpy()[keep],
                       rv.cpu().numpy()[keep], rr.cpu().numpy()[keep],
                       1e-4, 1e-5)
    say(f"[12d dense prf] F={F} alpha 0.6, Q=256: == flat_search_prf on "
        f"{len(keep)} queries ({swaps} rank slots inside near-ties; "
        f"{len(skip)} left out: their feedback sets differ inside near-ties)")
    return counts


def parallel_pipeline_phase(cascade, devices, reps):
    """12e: ``PipelinedCascade`` with stage 1 on mesh device 0 and stage 2
    on mesh device 1, on 8e's cascade: lists equal ``CascadeRetriever``'s,
    recall@10 the JAX 0.774.  Returns the pass's launch counts."""
    from tdr_torch.eval import recall_at_k
    from tdr_torch.parallel import PipelinedCascade

    cas, queries, want = cascade
    cand, rank = cas.candidate_models["en"], cas.rerank_models["en"]
    pipe = PipelinedCascade(cand, rank, stage1_device=devices[0],
                            stage2_device=devices[1], candidates=200,
                            query_batch=256)
    run = lambda: pipe.retrieve(queries.queries, "en", k=10)  # noqa: E731
    run()
    got, counts = counted(run)
    need(counts["tail_compact"] > 0, f"12e: K1 never ran {counts}")
    need(got == want, "12e: the pipelined lists differ from CascadeRetriever's")
    med, times = timed(run, reps)
    recall = recall_at_k(got, queries.positive_docs, 10)
    say(f"[12e pipelined cascade] stages on {devices[0]} / {devices[1]}, "
        f"candidates 200, batch 256: median {med:.4f} s of "
        f"{[round(t, 4) for t in times]} for {len(got)} queries -> "
        f"{len(got) / med:.1f} queries/s; recall@10 {recall:.4f}; launches "
        f"{counts}; lists == CascadeRetriever's")
    check_recall("12e", recall, 0.774)
    return counts


def parallel_ckpt_phase(model, queries, mesh):
    """12f: ``save_sharded_index`` / ``load_sharded_index`` of 12a's en
    index; the loaded model's lists and scores equal the built one's."""
    import shutil
    import tempfile

    import numpy as np
    from tdr_torch.ckpt import load_sharded_index, save_sharded_index
    from tdr_torch.rank import LanguageRouter

    tmp = tempfile.mkdtemp(prefix="tdr_sharded_")
    try:
        t0 = time.perf_counter()
        save_sharded_index(tmp, model.sindex)
        t_save = time.perf_counter() - t0
        n_bytes = sum(os.path.getsize(os.path.join(tmp, f))
                      for f in os.listdir(tmp))
        t0 = time.perf_counter()
        loaded = load_sharded_index(tmp, mesh)
        t_load = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    sel = [i for i, l in enumerate(queries.langs) if l == model.lang]
    qs, langs = [queries.queries[i] for i in sel], [model.lang] * len(sel)
    a_docs, a_scores = LanguageRouter({model.lang: model}, query_batch=256) \
        .retrieve_with_scores(qs, langs, k=10)
    b_docs, b_scores = LanguageRouter(
        {model.lang: dataclasses.replace(model, sindex=loaded)},
        query_batch=256).retrieve_with_scores(qs, langs, k=10)
    need(a_docs == b_docs and np.array_equal(a_scores, b_scores),
         "12f: the loaded sharded index's top-10 differs from the built one's")
    say(f"[12f sharded checkpoint] {model.lang}, {model.sindex.n_shards} "
        f"shards: {n_bytes / 1e9:.3f} GB written in {t_save:.2f} s, loaded "
        f"in {t_load:.2f} s; {len(sel)} queries' lists and scores equal")


def parallel_phase(models, queries, full_docs, full_scores, batch, flat,
                   q_enc, bench_emb, bench_q, cascade, card, reps):
    """Phase 12 (after phase 8, while phase 2's models, phase 7's dense
    index and 8e's cascade are on the card).  Returns launch counts by
    path."""
    import torch
    from tdr_torch.parallel import make_mesh

    t12 = time.perf_counter()
    count = torch.cuda.device_count()
    devices = [f"{DEVICE}:{i % count}" for i in range(4)]
    mesh = make_mesh(data=4, devices=devices)
    say(f"[12] mesh data=4 over {devices} ({count} CUDA device(s); a "
        f"repeated device runs its shards in sequence, and a copy to it is "
        f"no copy) on {card}")
    paths = {}
    sharded, paths["parallel_doc"] = parallel_doc_phase(
        models, queries, full_docs, full_scores, mesh, reps)
    paths["parallel_grid"] = parallel_grid_dp_phase(models, batch, devices)
    paths["parallel_vocab_tp"] = parallel_vocab_tp_phase(models, queries,
                                                         batch, devices)
    paths["parallel_dense"] = parallel_dense_phase(flat, q_enc, bench_emb,
                                                   bench_q, devices, reps)
    paths["parallel_pipeline"] = parallel_pipeline_phase(cascade, devices,
                                                         reps)
    parallel_ckpt_phase(sharded["en"], queries, mesh)
    del sharded
    gc.collect()
    torch.cuda.empty_cache()
    say(f"phase 12: {time.perf_counter() - t12:.1f} s on {card}")
    return paths


# -- phase 13: the CLI, serve, the sharded train step, real text -----------

def write_cli_inputs(corpus, queries, out):
    """``corpus`` and ``queries`` as ``synth`` writes them: corpus.json and
    dev.csv (query_id, query, positive_docs, lang)."""
    import csv

    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "corpus.json"), "w") as f:
        json.dump([{"docid": d, "text": t, "lang": l} for d, t, l in
                   zip(corpus.docids, corpus.texts, corpus.langs)], f)
    with open(os.path.join(out, "dev.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["query_id", "query", "positive_docs", "lang"])
        for row in zip(queries.query_ids, queries.queries,
                       queries.positive_docs, queries.langs):
            w.writerow(row)
    return os.path.join(out, "corpus.json"), os.path.join(out, "dev.csv")


def run_cli(argv):
    """``tdr_torch.cli.main(argv)`` in this process (so that launches
    count): (exit code, standard output)."""
    import contextlib
    import io

    from tdr_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([str(a) for a in argv])
    return rc, buf.getvalue()


class call_clock:
    """Wrap ``owner.name`` (a function or method) for the ``with`` block,
    adding each call's seconds to ``seconds[name]``."""

    def __init__(self, seconds, *targets):
        self.seconds, self.targets, self.saved = seconds, targets, []

    def __enter__(self):
        for owner, name in self.targets:
            fn = getattr(owner, name)
            self.saved.append((owner, name, fn))

            def timed_fn(*a, _fn=fn, _name=name, **k):
                import torch

                t0 = time.perf_counter()
                out = _fn(*a, **k)
                if DEVICE != "cpu":
                    torch.cuda.synchronize()
                self.seconds[_name] = (self.seconds.get(_name, 0.0)
                                       + time.perf_counter() - t0)
                return out

            setattr(owner, name, timed_fn)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self.saved:
            setattr(owner, name, fn)


def same_docs(got, docs, scores, rtol=1e-5, atol=1e-4):
    """A list without scores (a submission row, a served answer) against
    the router's list, which runs at least one rank deeper: equal, except
    that a doc may stand at a rank whose reference score it ties within the
    tolerance.  The deeper rank lets a swap at the last rank see its
    partner; a doc the reference does not list may tie only where the tie
    runs to the reference's end."""
    import numpy as np

    if len(docs) <= len(got) or len(scores) != len(docs):
        return False
    s = np.asarray(scores, np.float64)
    pos = {d: i for i, d in enumerate(docs)}
    for j, (a, b) in enumerate(zip(got, docs)):
        if a == b:
            continue
        tie = np.isclose(s, s[j], rtol=rtol, atol=atol)
        if not (tie[pos[a]] if a in pos else tie[-1]):
            return False
    return True


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def cli_phase(corpus, queries, deep_docs, deep_scores, tmp):
    """13a: phase 2's corpus and queries in ``synth``'s files, then the
    CLI's ``build`` (4 GiB head budget, bf16 heads), ``eval``, ``retrieve``
    and ``validate`` in this process; the submission's rows are held to the
    router's top-11 lists.  Returns (launches in ``eval``, the
    registry, the queries file)."""
    import tdr_torch.ckpt as ckpt
    from tdr_torch.eval import read_submission
    from tdr_torch.rank import LanguageRouter

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    corpus_path, q_path = write_cli_inputs(corpus, queries,
                                           os.path.join(tmp, "data"))
    write_s = time.perf_counter() - t0
    reg = os.path.join(tmp, "registry")
    secs = {}
    t0 = time.perf_counter()
    with call_clock(secs, (ckpt, "save_registry")):
        rc, _ = run_cli(["build", "--device", DEVICE, "--corpus", corpus_path,
                         "--out", reg, "--head-budget-gb",
                         HEAD_BUDGET / 2**30, "--head-dtype", "bfloat16"])
    build_s = time.perf_counter() - t0
    need(rc == 0, f"13a: build exited {rc}")
    with call_clock(secs, (ckpt, "load_registry"),
                    (LanguageRouter, "retrieve")):
        (rc, out), counts = counted(lambda: run_cli(
            ["eval", "--device", DEVICE, "--index", reg, "--queries",
             q_path]))
    need(rc == 0, f"13a: eval exited {rc}")
    report = json.loads(out)
    check_recall("13a CLI eval", report["recall@10"], 0.765)
    need(counts["tail_compact"] >= 1 and counts["fused_head"] >= 1,
         f"13a: eval did not launch K1 and K2: {counts}")
    nq = len(queries.queries)
    sub = os.path.join(tmp, "submission.csv")
    t0 = time.perf_counter()
    rc, _ = run_cli(["retrieve", "--device", DEVICE, "--index", reg,
                     "--queries", q_path, "--out", sub])
    retrieve_s = time.perf_counter() - t0
    need(rc == 0, f"13a: retrieve exited {rc}")
    ids, rows = read_submission(sub)
    need(ids == list(queries.query_ids), "13a: submission ids out of order")
    bad = [q for q in range(nq) if not same_docs(rows[q], deep_docs[q],
                                                   deep_scores[q])]
    need(not bad, f"13a: submission rows differ from phase 4's lists beyond "
                  f"near-ties at queries {bad[:10]}")
    swapped = sum(r != list(d[:10]) for r, d in zip(rows, deep_docs))
    rc, out = run_cli(["validate", "--submission", sub])
    need(rc == 0 and out.strip() == "OK", f"13a: validate: {rc} {out!r}")
    say(f"[13a cli] files written in {write_s:.1f} s; build {build_s:.1f} s "
        f"(of it save_registry {secs['save_registry']:.1f} s, "
        f"{dir_bytes(reg) / 1e9:.3f} GB); eval: load_registry "
        f"{secs['load_registry']:.1f} s, the pass "
        f"{secs['retrieve']:.3f} s -> {nq / secs['retrieve']:.1f} queries/s, "
        f"recall@10 {report['recall@10']:.4f}, launches {counts}; retrieve "
        f"{retrieve_s:.1f} s, {nq} rows equal to phase 4's lists "
        f"({swapped} inside near-ties); validate OK; phase 13a "
        f"{time.perf_counter() - t_phase:.1f} s")
    return counts, reg, q_path


class Server:
    """``python -m tdr_torch.cli serve`` as a subprocess: request lines
    in, answer lines out, every read with a timeout."""

    def __init__(self, reg, *flags, timeout=600):
        import queue
        import threading

        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "tdr_torch.cli", "serve", "--device",
             DEVICE, "--index", reg, "--k", "10", *flags],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, cwd=HERE, text=True, bufsize=1)
        self.out, self.err = queue.Queue(), queue.Queue()
        self.log = []
        for stream, q in ((self.proc.stdout, self.out),
                          (self.proc.stderr, self.err)):
            threading.Thread(target=self._pump, args=(stream, q),
                             daemon=True).start()
        self.load_s = None
        while True:                     # the log line after the warm-up
            line = self._get(self.err, timeout)
            self.log.append(line)
            if "loaded" in line and "models in" in line:
                self.load_s = float(line.split("models in")[1].split()[0])
            if "serving" in line:
                break
        self.ready_s = time.perf_counter() - self.t0

    @staticmethod
    def _pump(stream, q):
        for line in stream:
            q.put((time.perf_counter(), line.rstrip("\n")))
        q.put((time.perf_counter(), None))

    def _get(self, q, timeout):
        import queue

        try:
            _, line = q.get(timeout=timeout)
        except queue.Empty:
            self.close(kill=True)
            fail(f"serve: no line within {timeout} s; log {self.log[-5:]}")
        if line is None:
            self.close(kill=True)
            fail(f"serve ended early; log {self.log[-5:]}")
        return line

    def send(self, *requests):
        for r in requests:
            self.proc.stdin.write((r if isinstance(r, str)
                                   else json.dumps(r)) + "\n")
        self.proc.stdin.flush()

    def answers(self, n, timeout=120):
        return [json.loads(self._get(self.out, timeout)) for _ in range(n)]

    def close(self, kill=False, timeout=120):
        if kill:
            self.proc.kill()
            self.proc.wait(timeout=timeout)
            return self.proc.returncode
        self.proc.stdin.close()
        try:
            return self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            fail("serve did not exit within its timeout after end of input")


def serve_phase(reg, queries, deep_docs, deep_scores, router):
    """13b: the registry served by ``serve`` in a subprocess: 64 single
    requests over the seven languages, a burst of 256, a malformed line and
    a request with no ``lang``, answers held to the in-process router;
    then ``--mutable``: an add found, a delete gone."""
    import numpy as np

    t_phase = time.perf_counter()
    by_lang = {}
    for i, l in enumerate(queries.langs):
        by_lang.setdefault(l, []).append(i)
    singles = [i for k in range(64) for l in sorted(by_lang)
               if k < len(by_lang[l]) for i in [by_lang[l][k]]][:64]
    burst = list(range(256))

    def held(i, ans, docs, scores):
        need("error" not in ans, f"13b: an error for query {i}: {ans}")
        need(same_docs(ans["docids"], docs, scores)
             and np.allclose(ans["scores"], np.asarray(scores)[
                 :len(ans["scores"])], rtol=1e-5, atol=5e-5),
             f"13b: served answer for query {i} differs from the router's: "
             f"{ans} vs {list(docs)} {list(scores)}")

    srv = Server(reg)
    lat = []
    for i in singles:
        t0 = time.perf_counter()
        srv.send({"query": queries.queries[i], "lang": queries.langs[i],
                  "k": 10})
        ans = srv.answers(1)[0]
        lat.append(time.perf_counter() - t0)
        held(i, ans, deep_docs[i], deep_scores[i])
    t0 = time.perf_counter()
    srv.send(*[{"query": queries.queries[i], "lang": queries.langs[i]}
               for i in burst])
    got = srv.answers(len(burst))
    burst_s = time.perf_counter() - t0
    for i, ans in zip(burst, got):
        held(i, ans, deep_docs[i], deep_scores[i])
    j = singles[-1]
    srv.send("this is not json", {"query": queries.queries[j]})
    bad, nolang = srv.answers(2)
    need(set(bad) == {"error"}, f"13b: malformed line answered {bad}")
    d, sc = router.retrieve_with_scores([queries.queries[j]], [None], k=11)
    held(j, nolang, d[0], sc[0])
    rc = srv.close()
    need(rc == 0, f"13b: serve exited {rc}")
    say(f"[13b serve] start-up {srv.ready_s:.1f} s to the first request "
        f"(registry load {srv.load_s:.1f} s, then the warm-up of every "
        f"language at every bucket); {len(singles)} single requests over "
        f"{len(by_lang)} languages: median {statistics.median(lat) * 1e3:.2f}"
        f" ms (min {min(lat) * 1e3:.2f}, max {max(lat) * 1e3:.2f}); a burst "
        f"of {len(burst)}: {burst_s:.3f} s -> {len(burst) / burst_s:.1f} "
        f"queries/s; every answer equal to the router's (docids but for "
        f"near-ties, scores within rtol 1e-5 of serve's 4 places); the "
        f"malformed line answered {bad}; exit code {rc}")

    srv = Server(reg, "--mutable")
    text = "zyxqwv smokeprobe harbourlight"
    srv.send({"add": {"docid": "smoke-live-1", "text": text, "lang": "en"}})
    added = srv.answers(1)[0]
    srv.send({"query": text, "lang": "en"})
    found = srv.answers(1)[0]
    srv.send({"delete": "smoke-live-1"}, {"query": text, "lang": "en"})
    deleted, after = srv.answers(2)
    rc = srv.close()
    need(added == {"added": "smoke-live-1", "lang": "en"},
         f"13b: add answered {added}")
    need(found.get("docids", [None])[0] == "smoke-live-1",
         f"13b: the added doc was not found first: {found}")
    need(deleted == {"deleted": ["smoke-live-1"]}
         and "smoke-live-1" not in after.get("docids", ["smoke-live-1"]),
         f"13b: delete answered {deleted}, then {after}")
    need(rc == 0, f"13b: serve --mutable exited {rc}")
    say(f"[13b serve --mutable] start-up {srv.ready_s:.1f} s; add -> found "
        f"first (score {found['scores'][0]}); delete -> not returned; "
        f"phase 13b {time.perf_counter() - t_phase:.1f} s")


def cli_dense_phase(dense, queries, q_path, tmp):
    """13c: phase 7's dense model saved with ``save_dense_model`` and
    retrieved by the CLI's ``retrieve-dense``: one K3 launch, the lists of
    ``DenseModel.retrieve``."""
    from tdr_torch.ckpt import save_dense_model
    from tdr_torch.eval import read_submission

    path, sub = os.path.join(tmp, "dense"), os.path.join(tmp, "dense.csv")
    t0 = time.perf_counter()
    save_dense_model(path, dense)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    (rc, out), counts = counted(lambda: run_cli(
        ["retrieve-dense", "--device", DEVICE, "--index", path, "--queries",
         q_path, "--out", sub]))
    cli_s = time.perf_counter() - t0
    need(rc == 0, f"13c: retrieve-dense exited {rc}")
    need(counts["fused_flat"] == 1,
         f"13c: retrieve-dense launched K3 {counts['fused_flat']} times")
    ref = dense.retrieve(queries.queries, k=10)
    rows = read_submission(sub)[1]
    need(rows == ref, "13c: retrieve-dense lists differ from "
                      "DenseModel.retrieve's")
    say(f"[13c retrieve-dense] save_dense_model {save_s:.1f} s "
        f"({dir_bytes(path) / 1e6:.1f} MB); the command (load, encode, "
        f"search) {cli_s:.1f} s; launches {counts}; {len(rows)} lists equal "
        f"to DenseModel.retrieve's; recall@10 "
        f"{json.loads(out)['recall@10']:.4f}")
    return counts


def sharded_train_phase(batches, cfg=None, n_steps=20, devices=None):
    """13d: the sharded train step at ``DenseConfig()`` width on a
    ("data" 2, "model" 2) mesh over ``cuda:(i % device_count)``, from one
    init against the single-device step: losses at every step within rtol
    1e-2 and params (99th percentile within lr, every entry within Adam's
    bound), the bounds ``tests/test_torch_train_sharded.py`` measures both
    packages' CPU gaps against; data replicas bit-equal; per-device bytes
    equal to ``train_state_layout``; a checkpoint round trip of the
    sharded state equal to straight training for 2 more steps."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from tdr_torch.ckpt import load_train_state, save_train_state
    from tdr_torch.parallel import make_mesh
    from tdr_torch.parallel.train import train_state_layout
    from tdr_torch.train import (create_train_state, make_train_step,
                                 shard_train_state, unshard_train_state)
    from tdr_torch.utils.config import DenseConfig

    t_phase = time.perf_counter()
    cfg = cfg or DenseConfig()
    lr = 1e-3
    if devices is None:
        n = torch.cuda.device_count() if DEVICE != "cpu" else 1
        devices = [DEVICE if DEVICE == "cpu" else f"cuda:{i % n}"
                   for i in range(4)]
    mesh = make_mesh(data=2, model=2, devices=devices)
    need(len(batches) >= n_steps + 2, f"13d: {len(batches)} batches")
    step = make_train_step()
    single = create_train_state(cfg, lr=lr, seed=0, device=DEVICE)
    sharded = shard_train_state(mesh, create_train_state(
        cfg, lr=lr, seed=0, device=DEVICE))
    want = train_state_layout(cfg, mesh)
    need(sharded.per_device_bytes() == want,
         f"13d: per-device bytes {sharded.per_device_bytes()} != layout "
         f"{want}")
    whole = sum(p.numel() * 12 for p in single.model.parameters())

    mesh_devs = sorted({str(x) for x in mesh.devices.flat})

    def run(state):
        losses, times = [], []
        if DEVICE != "cpu":
            for d in mesh_devs:
                torch.cuda.reset_peak_memory_stats(d)
        for b in batches[:n_steps]:
            t0 = time.perf_counter()
            state, m = step(state, b)
            losses.append(m["loss"].item())          # waits for the step
            times.append(time.perf_counter() - t0)
        peak = ({d: torch.cuda.max_memory_allocated(d) for d in mesh_devs}
                if DEVICE != "cpu" else {})
        return state, np.array(losses), times, peak

    single, l1, t1, p1 = run(single)
    sharded, l2, t2, p2 = run(sharded)
    gap = np.abs(l2 - l1) / l1
    need(np.isfinite(l2).all() and gap.max() <= 1e-2,
         f"13d: sharded losses {l2.round(5).tolist()} against unsharded "
         f"{l1.round(5).tolist()} (gap {gap.max():.3g}, limit rtol 1e-2)")
    a = unshard_train_state(sharded).model.state_dict()
    b = single.model.state_dict()
    d = torch.cat([(a[k].float() - b[k].float()).abs().flatten().cpu()
                   for k in a if not k.endswith("attn.key.bias")]).numpy()
    worst = max((a[k] - b[k]).abs().max().item() for k in a)
    q99 = float(np.quantile(d, 0.99))
    need(q99 <= lr and worst <= 2 * n_steps * 1.004 * lr,
         f"13d: params after {n_steps} steps: 99th percentile {q99:.3g} "
         f"(limit {lr}), max {worst:.3g} (Adam's bound "
         f"{2 * n_steps * 1.004 * lr:.3g})")
    rows, n_model = mesh.shape["data"], mesh.shape["model"]
    for dd in range(1, rows):
        for m in range(n_model):
            pa, pb = sharded.params[dd][m], sharded.params[0][m]
            oa, ob = sharded.optimizers[dd][m], sharded.optimizers[0][m]
            for k in pa:
                same = torch.equal(pa[k].cpu(), pb[k].cpu()) and all(
                    torch.equal(oa.state[pa[k]][s].cpu(),
                                ob.state[pb[k]][s].cpu())
                    for s in ("exp_avg", "exp_avg_sq"))
                need(same, f"13d: data replica {dd} of model shard {m} "
                           f"differs from replica 0 at {k}")
    tmp = tempfile.mkdtemp(prefix="tdr_sharded_")
    try:
        path = os.path.join(tmp, "state")
        save_train_state(path, sharded)

        def resumed():
            st = load_train_state(path, shard_train_state(
                mesh, create_train_state(cfg, lr=lr, seed=7, device=DEVICE)))
            for bb in batches[n_steps:n_steps + 2]:
                st, _ = step(st, bb)
            return st

        straight = sharded
        for bb in batches[n_steps:n_steps + 2]:
            straight, _ = step(straight, bb)
        r1, r2 = resumed(), resumed()

        def differ(x, y):
            out = 0.0
            for row_x, row_y, ox, oy in zip(x.params, y.params, x.optimizers,
                                            y.optimizers):
                for px, py, qx, qy in zip(row_x, row_y, ox, oy):
                    for k in px:
                        out = max(out, (px[k] - py[k]).abs().max().item(),
                                  *[(qx.state[px[k]][s] - qy.state[py[k]][s])
                                    .abs().max().item()
                                    for s in ("exp_avg", "exp_avg_sq")])
            return out

        spread, resume_gap = differ(r1, r2), differ(straight, r1)
        need(r1.step == straight.step == n_steps + 2
             and resume_gap <= spread,
             f"13d: save + load + 2 sharded steps differ from 2 straight "
             f"steps by {resume_gap:.3g} (two resumed runs: {spread:.3g})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ms1, ms2 = statistics.median(t1) * 1e3, statistics.median(t2) * 1e3
    say(f"[13d sharded train] dim {cfg.dim} depth {cfg.depth} heads "
        f"{cfg.heads} {cfg.dtype}, batches of {batches[0]['q_ids'].shape[0]} "
        f"x (1 + 1 + {batches[0]['n_ids'].shape[1]}) x {cfg.max_len} tokens; "
        f"mesh data 2 x model 2 over {[str(x) for x in mesh.devices.flat]}: "
        f"{n_steps} steps, step median sharded {ms2:.2f} ms against "
        f"unsharded {ms1:.2f} ms in this process ({ms2 / ms1:.2f}x); losses "
        f"{l1[0]:.4f} -> {l1[-1]:.4f} unsharded, {l2[0]:.4f} -> "
        f"{l2[-1]:.4f} sharded, largest gap {gap.max():.3g} (rtol 1e-2); "
        f"params 99th percentile {q99:.3g} (limit {lr}), max {worst:.3g}; "
        f"data replicas bit-equal; per-device param + moment bytes {want} "
        f"== layout (one unsharded state {whole}); max_memory_allocated, "
        f"both states resident, unsharded "
        f"{ {k: round(v / 2**30, 3) for k, v in p1.items()} } GiB, sharded "
        f"{ {k: round(v / 2**30, 3) for k, v in p2.items()} } GiB; resume "
        f"gap {resume_gap:.3g} (two resumed runs {spread:.3g}); phase 13d "
        f"{time.perf_counter() - t_phase:.1f} s")


def cli_train_phase(tmp, mesh_arg="2x2"):
    """The CLI's ``train --mesh 2x2`` at ``DenseConfig()`` width on a
    ``synth`` corpus (2,000 docs, 256 train queries, one epoch of batches
    of 64): ``tdr``'s rule takes a mesh only when more than one CUDA
    device is visible, so on one card the step is unsharded and on four
    it is the sharded one over every card.  The checkpoint it writes loads
    and retrieves."""
    import torch
    import tdr_torch.train as train_pkg
    from tdr_torch.ckpt import load_dense_model
    from tdr_torch.data import load_queries
    from tdr_torch.train import ShardedTrainState

    t0 = time.perf_counter()
    data, ck = os.path.join(tmp, "train_data"), os.path.join(tmp, "dense")
    rc, _ = run_cli(["synth", "--docs", 2000, "--queries", 256, "--seed", 5,
                     "--out", data])
    need(rc == 0, f"13d: synth exited {rc}")
    seen = {}
    real = train_pkg.train_dense_retriever

    def spy(*a, **k):
        out = real(*a, **k)
        seen["mesh"], seen["state"] = k.get("mesh"), out[1]
        return out

    train_pkg.train_dense_retriever = spy
    try:
        rc, _ = run_cli(["train", "--device", DEVICE, "--corpus",
                         os.path.join(data, "corpus.json"), "--train",
                         os.path.join(data, "train.csv"), "--out", ck,
                         "--mesh", mesh_arg, "--epochs", 1, "--batch", 64])
    finally:
        train_pkg.train_dense_retriever = real
    need(rc == 0, f"13d: train exited {rc}")
    n_dev = torch.cuda.device_count() if DEVICE != "cpu" else 1
    sharded = isinstance(seen["state"], ShardedTrainState)
    need(sharded == (n_dev > 1),
         f"13d: train --mesh {mesh_arg} on {n_dev} device(s) ran "
         f"{'sharded' if sharded else 'unsharded'}")
    if sharded:
        devs = sorted({str(d) for d in seen["mesh"].devices.flat})
        need(len(devs) == min(4, n_dev), f"13d: train's mesh spans {devs}")
    dense = load_dense_model(ck, device=DEVICE)
    qs = load_queries(os.path.join(data, "dev.csv"))
    res = dense.retrieve(qs.queries, k=10)
    need(all(len(r) == 10 for r in res), "13d: the trained checkpoint's "
                                         "lists are short")
    say(f"[13d cli train] train --mesh {mesh_arg} on {n_dev} device(s): "
        f"{'sharded over ' + str(sorted({str(d) for d in seen['mesh'].devices.flat})) if sharded else 'unsharded (one device visible)'}"
        f", {seen['state'].step} steps; the checkpoint loads and retrieves "
        f"{len(res)} lists; {time.perf_counter() - t0:.1f} s")


def realtext_phase():
    """13e: ``real_eval_corpus`` (140 docs, 70 queries, seven languages)
    through the build and the router on the card at the "best" and
    "porter" pipelines, held to the same calls on the CPU; "best" to the
    recall floors of ``tests/test_realtext_eval.py`` (0.95, 0.90)."""
    from tdr_torch.data.loaders import Corpus
    from tdr_torch.data.realtext import real_eval_corpus
    from tdr_torch.eval import recall_at_k
    from tdr_torch.rank import LanguageRouter, build_language_models
    from tdr_torch.text import Preprocessor

    docs, docids, dlangs, qs, qlangs, positives = real_eval_corpus()
    out = []
    for pipeline in ("best", "porter"):
        lists = {}
        for dev in (DEVICE, "cpu"):
            models = build_language_models(
                Corpus(docids, docs, dlangs),
                preprocessor=Preprocessor(pipeline), device=dev)
            router = LanguageRouter(models, query_batch=16,
                                    preprocessor=Preprocessor(pipeline))
            lists[dev] = router.retrieve_with_scores(qs, qlangs, k=10)
        (d, s), (rd, rs) = lists[DEVICE], lists["cpu"]
        bad = [q for q in range(len(qs)) if not same_ranking(
            d[q], s[q], rd[q], rs[q])]
        need(not bad, f"13e {pipeline}: card lists differ from the CPU's at "
                      f"queries {bad[:10]}")
        r10 = recall_at_k(d, positives, 10)
        r1 = recall_at_k([r[:1] for r in d], positives, 1)
        if pipeline == "best":
            need(r10 >= 0.95 and r1 >= 0.90,
                 f"13e: real-text recall@10 {r10:.4f} / @1 {r1:.4f} below "
                 f"0.95 / 0.90")
        out.append(f"{pipeline}: recall@10 {r10:.4f}, recall@1 {r1:.4f}")
    say(f"[13e real text] {len(docs)} docs, {len(qs)} queries, card lists "
        f"== CPU lists; " + "; ".join(out))


# -- phase 13f: tdr's public helpers and engine keywords on the card -------

def api_phase(models, batch, flat, q_enc):
    """Phase 13f.  ``segment_df``, ``compute_idf`` and ``select_head`` on
    the card from en's and es's COO, held bit for bit to phase 2's indexes
    (and ``select_head``'s ties to a host lexsort in ``lax.top_k``'s
    order); ``nnz`` and ``memory_bytes()`` of every phase-2 model against
    its tensors' storages; each of ``tdr``'s ``tail_engine`` values through
    K1 and a ``recall_target`` through K3, one launch each, with the
    default call's lists."""
    import numpy as np
    import torch
    from tdr_torch.index.build import compute_idf, segment_df, select_head
    from tdr_torch.models.dense import flat_search
    from tdr_torch.ops.score import score_and_topk_fused
    from tdr_torch.ops.tail_compact import tail_segments

    t0 = time.perf_counter()
    for lang in ("en", "es"):
        ix = models[lang].index
        terms = coo_from_index(ix)[1]
        df = segment_df(torch.as_tensor(terms, device=DEVICE), ix.vocab_size)
        idf = compute_idf(df, ix.n_docs)
        slot = select_head(df, ix.head_size)
        need(all(t.device == ix.device for t in (df, idf, slot)),
             f"13f {lang}: a helper's result is off the index's device")
        for name, got, want in (("segment_df", df, ix.stats.df),
                                ("compute_idf", idf, ix.stats.idf),
                                ("select_head", slot, ix.head_slot)):
            need(got.dtype == want.dtype and torch.equal(got, want),
                 f"13f {lang}: {name} differs from the index's")
        df_h = np.bincount(terms, minlength=ix.vocab_size).astype(np.float32)
        need(np.array_equal(df.cpu().numpy(), df_h),
             f"13f {lang}: segment_df differs from the host count")
        order = np.lexsort((np.arange(df_h.size), -df_h))[:ix.head_size]
        keep = df_h[order] > 0
        slot_h = np.full(df_h.size, -1, np.int32)
        slot_h[order[keep]] = np.arange(order.size, dtype=np.int32)[keep]
        need(np.array_equal(slot.cpu().numpy(), slot_h),
             f"13f {lang}: select_head's ties are not in lax.top_k's order")
        n = np.float32(ix.n_docs)
        idf_h = np.log1p((n - df_h + 0.5) / (df_h + 0.5)).astype(np.float32)
        idf_c = idf.cpu().numpy()
        ulps = np.abs(idf_c.view(np.int32).astype(np.int64)
                      - idf_h.view(np.int32))
        need(np.allclose(idf_c, idf_h, rtol=1e-6, atol=0),
             f"13f {lang}: idf on the card {ulps.max()} ulps from the host "
             f"formula")
        head_df = df_h[order]
        say(f"[13f {lang}] vocab {ix.vocab_size}, {terms.size} postings: "
            f"segment_df, compute_idf, select_head on {df.device} == the "
            f"index's bit for bit; head of {ix.head_size} in lax.top_k order "
            f"({head_df.size - np.unique(head_df).size} tied df entries); "
            f"idf vs the host formula: max {ulps.max()} ulp, "
            f"{(ulps > 0).mean():.2%} of terms differ")
    for lang, m in sorted(models.items()):
        ix = m.index
        tensors = [ix.indptr, ix.postings_doc, ix.postings_w, ix.postings_tf,
                   ix.head_slot, ix.head_rows, ix.head_scale, ix.stats.df,
                   ix.stats.idf, ix.stats.doc_len, ix.stats.avgdl]
        stored = sum(t.untyped_storage().nbytes() for t in tensors
                     if t is not None)
        need(ix.memory_bytes() == stored,
             f"13f {lang}: memory_bytes {ix.memory_bytes()} != storages "
             f"{stored}")
        need(ix.nnz >= int(ix.indptr[-1]),
             f"13f {lang}: nnz {ix.nnz} short of the postings")
        say(f"[13f {lang}] nnz {ix.nnz}, memory_bytes {ix.memory_bytes()} "
            f"({ix.memory_bytes() / 2**20:.1f} MiB) == its storages")

    m = models["es"]
    qids, qw = batch("es", 256)
    budget = min(max(m.tail_budget, 4 * m.index.tail_pmax),
                 16 * m.index.tail_pmax)
    over = tail_segments(m.index, qids, qw, budget)[4]
    fine = ~over

    def call(**kw):
        return score_and_topk_fused(m.index, qids, qw, top_k=10,
                                    tail_budget=m.tail_budget, **kw)

    (bv, br), c = counted(call)
    need(c["tail_compact"] == 1, f"13f es default call launches {c}")
    for v in ("auto", "xla", "pallas", "pallas_interpret"):
        (gv, gr), c = counted(lambda: call(tail_engine=v))
        need(c["tail_compact"] == 1 and sum(c.values()) == 1,
             f"13f es tail_engine={v!r} launches {c}, not one K1")
        # overflowing queries take the scatter path, whose float atomics
        # may order a sum differently from one call to the next
        need(torch.equal(gr[fine], br[fine]) and torch.equal(gv[fine], bv[fine]),
             f"13f es tail_engine={v!r}: lists differ from the default call's")
        hold_lists(f"13f es tail_engine={v!r} overflow", gv[over].cpu().numpy(),
                   gr[over].cpu().numpy(), bv[over].cpu().numpy(),
                   br[over].cpu().numpy(), 1e-6, 1e-6)
    q = q_enc[:256]
    (fv, fr), c0 = counted(lambda: flat_search(flat, q, 10))
    (rv, rr), c = counted(lambda: flat_search(flat, q, 10, recall_target=0.5))
    need(c0["fused_flat"] == c["fused_flat"] == 1,
         f"13f flat_search launches {c0} (default), {c} (recall_target)")
    need(torch.equal(rv, fv) and torch.equal(rr, fr),
         "13f flat_search(recall_target=0.5) differs from the default call")
    say(f"[13f] es Q=256 ({int(over.sum())} overflow): every tail_engine "
        f"value one K1 launch with the default call's lists; flat_search "
        f"with recall_target one K3 launch, the same lists; phase 13f "
        f"{time.perf_counter() - t0:.1f} s on {card_line()}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--queries", type=int, default=2000)
    ap.add_argument("--reps", type=int, default=5, help="timed passes")
    ap.add_argument("--profile", action="store_true",
                    help="trace one more sparse, dense, PRF, f32-head "
                         "sparse and sentence-cascade pass (and 32 batches "
                         "of the sentence embedding pass, 4 train steps at "
                         "DenseConfig() width) with "
                         "torch.profiler: device time by kernel and the "
                         "device's busy share")
    ap.add_argument("--trace-out", default=None,
                    help="with --profile: write the sparse pass's Chrome "
                         "trace to this file")
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
        device=DEVICE)
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

    def batch(lang, n, start=0):
        qs = [q for q, l in zip(queries.queries, queries.langs)
              if l == lang][start:start + n]
        toks = router._tokenize(qs, range(len(qs)), lang)
        toks = toks + [[]] * (n - len(toks))
        return models[lang].encode_query_tokens(toks)

    k2_ix = models[k2_lang].index
    qids, qw = batch(k2_lang, 256)
    rec_k2 = check_fused_head(k2_ix, qids, qw, f"{k2_lang} Q=256")
    check_fused_head(k2_ix, qids, torch.zeros_like(qw), "no head term",
                     want_active=0)
    n_k2 = sum(1 for l in queries.langs if l == k2_lang)
    last = (n_k2 - 1) % 256 + 1                 # the router's last batch
    last_batch = batch(k2_lang, last, n_k2 - last)
    check_fused_head(k2_ix, *last_batch, f"{k2_lang} last batch Q={last}")
    cover_ix, cover_qids, cover_qw = cover_batch(k2_ix)
    check_fused_head(cover_ix, cover_qids, cover_qw, "full coverage",
                     want_active=k2_ix.head_rows.shape[0])
    del cover_ix
    check_fused_head_ragged(k2_ix, qids, qw)
    rec_k2f = check_fused_head_f32(k2_ix, [
        (qids, qw, f"{k2_lang} Q=256", None),
        (qids, torch.zeros_like(qw), "no head term", 0),
        (*last_batch, f"{k2_lang} last batch Q={last}", None)])
    rec_k1 = k1_cases(models, router, queries, k1_lang, batch)

    # -- phase 3b: K3 at the dense bench's shape -----------------------------
    import numpy as np

    bench_emb, bench_q = bench_embeddings()
    bq = torch.as_tensor(bench_q, device=DEVICE)
    for dtype in ("bfloat16", "int8", "float32"):
        for metric in ("ip", "l2"):
            index = flat_index_on_card(bench_emb, metric, dtype)
            check_fused_flat(index, bq, f"{dtype} {metric}")
            if dtype == "bfloat16" and metric == "ip":
                check_fused_flat(index, bq, "bfloat16 ip n_valid=100000",
                                 n_valid=100_000)
            del index
    # the last document tile ragged (N % 256 = 64), and rows too deep for
    # the resident query slab (D = 768 bf16: the query tile streams)
    from tdr_torch.models.dense import build_flat_index
    extra = np.random.RandomState(1).randn(64, 256).astype(np.float32)
    extra /= np.linalg.norm(extra, axis=1, keepdims=True)
    ragged = np.concatenate([bench_emb, extra])
    for dtype in ("bfloat16", "int8"):
        index = build_flat_index(ragged, pad_multiple=64, dtype=dtype,
                                 device=DEVICE)
        check_fused_flat(index, bq, f"{dtype} ip ragged N={ragged.shape[0]}")
        del index
    deep = np.random.RandomState(2).randn(65_664, 768).astype(np.float32)
    deep /= np.linalg.norm(deep, axis=1, keepdims=True)
    index = build_flat_index(deep, dtype="bfloat16", device=DEVICE)
    check_fused_flat(index, torch.as_tensor(
        np.random.RandomState(3).randn(256, 768).astype(np.float32),
        device=DEVICE), "bfloat16 ip D=768 streamed query tile")
    del index, deep, ragged

    # -- phase 3c: K4 on the en and de heads ---------------------------------
    head_langs = [l for l in ("en", "de") if l in models]
    cuda_build.reset_launches()
    from tdr_torch.ops.head_scores import head_scores

    qids, qw = overflow_batch(models[head_langs[0]].index,
                              *batch(head_langs[0], 256))
    head_scores(models[head_langs[0]].index, qids, qw)
    torch.cuda.synchronize()
    k4_launches = cuda_build.launches["head_scores"]
    if k4_launches == 0:
        fail("head_scores never launched in its own pass")
    rec_k4 = None
    for lang in head_langs:
        for n in (1, 8, 256):
            qids, qw = batch(lang, n)
            if n > 1:
                qids, qw = overflow_batch(models[lang].index, qids, qw)
            rec = check_head_scores(models[lang].index, qids, qw,
                                    f"{lang} Q={n}")
            if lang == head_langs[0] and n == 256:
                rec_k4 = rec
    rec_k4["launches"] = k4_launches

    # -- phase 3d: the encoder's LayerNorm kernels ---------------------------
    rec_ln = layer_norm_phase()

    # -- phase 3e: the encoder's attention kernels ---------------------------
    rec_attn = attention_phase()

    # -- phase 3f: the train step's AdamW kernel -----------------------------
    rec_adamw = adamw_phase()

    # -- phase 4: the main path ----------------------------------------------
    cuda_build.reset_launches()
    router.retrieve(queries.queries, queries.langs, k=10)
    torch.cuda.synchronize()
    counts = dict(cuda_build.launches)
    say(f"launches in one {args.queries}-query pass: {counts}")
    missing = [k for k in ("tail_compact", "fused_head") if counts[k] == 0]
    if missing:
        fail(f"kernels never launched on the sparse path: {missing}")
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
        profile_pass("sparse", lambda: router.retrieve(
            queries.queries, queries.langs, k=10), args.trace_out)

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
    single_query_latency(router, queries, k1_lang)

    # -- phase 6: reference check --------------------------------------------
    reference_check(models, queries.queries, queries.langs)
    rec_k1["launches"] = counts["tail_compact"]
    rec_k2["launches"] = counts["fused_head"]

    # -- phase 7: the dense path ---------------------------------------------
    rec_k3, rec_k3f, dense, q_enc = dense_phase(corpus, queries, bench_emb,
                                                bench_q, args.reps,
                                                args.profile)
    flat = dense.flat

    # -- phase 8: the rest of the sparse path --------------------------------
    t8 = time.perf_counter()
    paths = {"prf": prf_phase(models, queries, args.reps, args.profile)}
    for mode, c in topk_modes_phase(models, queries, full_docs,
                                    full_scores).items():
        paths[mode] = c
    for key, c in segmented_phase(models, queries, args.reps).items():
        paths[f"segmented_{key}"] = c
    paths["candidates"] = candidates_phase(models, queries)
    paths["cascade"], cascade = cascade_phase(3)
    checkpoint_phase(models, queries)
    say(f"phase 8: {time.perf_counter() - t8:.1f} s")

    # -- phase 12: the parallel serving layer (run here, while phase 2's
    # models, phase 7's dense index and 8e's cascade are on the card) ------
    paths.update(parallel_phase(models, queries, full_docs, full_scores,
                                batch, flat, q_enc, bench_emb, bench_q,
                                cascade, card, args.reps))
    del cascade

    # -- phase 13a-c: the CLI in this process, serve as a subprocess -------
    import shutil
    import tempfile

    t13 = time.perf_counter()
    tmp13 = tempfile.mkdtemp(prefix="tdr_cli_")
    # phase 4's lists one rank deeper: 13a-b's answers carry no scores of
    # their own to hold a swap at rank 10 to
    deep_docs, deep_scores = router.retrieve_with_scores(
        queries.queries, queries.langs, k=11)
    try:
        paths["cli_eval"], reg, q_path = cli_phase(corpus, queries, deep_docs,
                                                   deep_scores, tmp13)
        serve_phase(reg, queries, deep_docs, deep_scores, router)
        shutil.rmtree(reg, ignore_errors=True)
        k3_cli = cli_dense_phase(dense, queries, q_path, tmp13)
    finally:
        shutil.rmtree(tmp13, ignore_errors=True)
    del dense
    say(f"phase 13a-c: {time.perf_counter() - t13:.1f} s")
    api_phase(models, batch, flat, q_enc)
    for rec in (rec_k1, rec_k2):
        rec["launches_by_path"] = {p: c[rec["name"]] for p, c in paths.items()}

    # -- phase 9a: the sparse pass at f32 heads ------------------------------
    t9 = time.perf_counter()
    del router, models, k2_ix, batch
    gc.collect()
    torch.cuda.empty_cache()
    f32_counts, f32_models, f32_ref = f32_heads_phase(
        corpus, queries, args.reps, med, args.profile)
    rec_k2f["launches"] = f32_counts["fused_head_f32"]
    rec_k2f["launches_by_path"] = {"sparse_f32_heads":
                                   f32_counts["fused_head_f32"]}
    rec_k3f["launches_by_path"] = {"dense_f32": rec_k3f["launches"]}
    say(f"phase 9a: {time.perf_counter() - t9:.1f} s")

    # -- phase 9c: the f32 checks again with TF32 turned on -----------------
    t9 = time.perf_counter()
    tf32_phase(f32_models, f32_ref, flat, q_enc, bench_emb, bench_q)
    del f32_models, flat
    say(f"phase 9c: {time.perf_counter() - t9:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 10: the sentence-BM25 -> BERT re-rank cascade ----------------
    sent_counts, s_corpus, s_queries, sb = sentence_phase(
        profile=args.profile)
    for rec in (rec_k1, rec_k2):
        rec["launches_by_path"]["sentence_cascade"] = sent_counts[rec["name"]]

    # -- phase 11: dense-encoder training, then the SVD and small learners --
    t11 = time.perf_counter()
    mined, train_paths = train_flow_phase(s_corpus, s_queries, sb)
    del sb
    gc.collect()
    torch.cuda.empty_cache()
    train_paths["train_dense_eval"] = train_width_phase(
        s_corpus, s_queries, mined, profile=args.profile)

    # -- phase 13d: the sharded train step on 11b's batches -----------------
    import itertools

    from tdr_torch.train.contrastive import make_batches
    from tdr_torch.utils.config import DenseConfig

    sharded_train_phase(list(itertools.islice(make_batches(
        mined, dict(zip(s_corpus.docids, s_corpus.texts)), DenseConfig(), 50,
        2, seed=0), 22)))
    tmp13 = tempfile.mkdtemp(prefix="tdr_cli_")
    try:
        cli_train_phase(tmp13)
    finally:
        shutil.rmtree(tmp13, ignore_errors=True)
    train_tf32_phase(s_corpus, mined)
    extras_phase(corpus)
    rec_k2["launches_by_path"]["train_mining"] = \
        train_paths["train_mining"]["fused_head"]
    rec_k1["launches_by_path"]["train_sentence_cascade"] = \
        train_paths["train_sentence_cascade"]["tail_compact"]
    rec_k3["launches_by_path"] = {
        "dense": rec_k3["launches"],
        "train_dense_eval": train_paths["train_dense_eval"]["fused_flat"],
        "parallel_dense": paths["parallel_dense"]["fused_flat"],
        "cli_retrieve_dense": k3_cli["fused_flat"]}
    say(f"phase 11 (and 13d): {time.perf_counter() - t11:.1f} s")

    # -- phase 13e: real text at the "best" and "porter" pipelines ---------
    t13 = time.perf_counter()
    _, real_counts = counted(realtext_phase)
    for rec in (rec_k1, rec_k2):
        rec["launches_by_path"]["realtext"] = real_counts[rec["name"]]
    say(f"phase 13e: {time.perf_counter() - t13:.1f} s")

    say(f"total {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": [rec_k1, rec_k2, rec_k2f, rec_k3, rec_k3f,
                                rec_k4, *rec_ln, *rec_attn, rec_adamw]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
