"""tdr_torch command-line interface: the port of ``tdr/cli.py``.

The reference has no entry points — reproduction means running scripts in
README order with pickles appearing in the working directory (README.md
"Reproduce our results").  Here: one CLI over the checkpointed registry.

    python -m tdr_torch.cli build    --corpus corpus.json --out idx/ [--model bm25|cosine]
    python -m tdr_torch.cli retrieve --index idx/ --queries test.csv --out submission.csv
    python -m tdr_torch.cli eval     --index idx/ --queries dev.csv
    python -m tdr_torch.cli validate --submission submission.csv
    python -m tdr_torch.cli synth    --docs 1000 --queries 100 --out data/
    python -m tdr_torch.cli serve    --index idx/            # JSON-lines server

The same eleven subcommands, flags, defaults, outputs and exit codes as
``tdr``'s, plus ``--device`` on each (default ``cuda``; ``--device cpu``
runs on the CPU; without CUDA the default raises, it never falls back).
Registries and checkpoints are ``tdr``'s formats, so either CLI reads the
other's.  ``serve`` answers a malformed request with an ``{"error": ...}``
line, but a kernel that fails to build or launch, or any CUDA error, ends
the server instead of becoming an answer.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _device_fault(e: BaseException) -> bool:
    """A kernel that failed to build or launch, or a CUDA error (the card
    asked for and missing included): such a failure ends the command; it
    is never answered as a bad request or skipped as a bad line."""
    import torch

    from tdr_torch.ops.cuda_build import KernelError

    kinds = (KernelError, torch.cuda.OutOfMemoryError)
    if hasattr(torch, "AcceleratorError"):
        kinds += (torch.AcceleratorError,)
    return isinstance(e, kinds) or (isinstance(e, RuntimeError)
                                    and "CUDA" in str(e))


def _cmd_build(args) -> int:
    from tdr_torch.ckpt import save_registry
    from tdr_torch.data import load_corpus
    from tdr_torch.models import BM25Model, TfidfCosineModel
    from tdr_torch.rank import build_language_models
    from tdr_torch.utils.config import TdrConfig
    from tdr_torch.utils.trace import Tracer, log

    cfg = TdrConfig.from_json(open(args.config).read()) if args.config else TdrConfig()
    if args.head_budget_gb is not None:
        import dataclasses as _dc

        cfg = _dc.replace(cfg, index=_dc.replace(
            cfg.index, head_budget_bytes=int(args.head_budget_gb * (1 << 30))))
    if getattr(args, "head_dtype", None) is not None:
        import dataclasses as _dc

        cfg = _dc.replace(cfg, index=_dc.replace(
            cfg.index, head_dtype=args.head_dtype))
    corpus = load_corpus(args.corpus)
    model_cls = {"bm25": BM25Model, "cosine": TfidfCosineModel}[args.model]
    tracer = Tracer("build")
    models = build_language_models(
        corpus, model_cls, bm25=cfg.bm25, index_cfg=cfg.index,
        max_query_terms=cfg.retrieval.max_query_terms, tracer=tracer,
        use_native=not args.no_native, device=args.device)
    save_registry(args.out, models, extra_meta={"model": args.model,
                                                "config": json.loads(cfg.to_json())})
    log.info("saved %d language models to %s", len(models), args.out)
    print(tracer.report())
    return 0


def _apply_spell(models, args):
    """Opt-in query-robustness knobs on every loaded model: trigram OOV
    repair (tdr_torch.text.spell) and/or RM3 pseudo-relevance feedback
    (tdr_torch.rank.feedback)."""
    import dataclasses as _dc

    if getattr(args, "spell_correct", False):
        models = {l: _dc.replace(m, spell_correct=True)
                  for l, m in models.items()}
    if getattr(args, "prf", False):
        models = {l: _dc.replace(m, prf=True) for l, m in models.items()}
    return models


def _cmd_retrieve(args) -> int:
    from tdr_torch.ckpt import load_registry
    from tdr_torch.data import load_queries
    from tdr_torch.eval import write_submission, validate_submission
    from tdr_torch.rank import LanguageRouter
    from tdr_torch.utils.trace import log

    models = _apply_spell(load_registry(args.index, device=args.device),
                          args)
    queries = load_queries(args.queries)
    router = LanguageRouter(models, query_batch=args.batch)
    results = router.retrieve(queries.queries, queries.langs, k=args.k)
    write_submission(results, args.out, ids=queries.query_ids, k=args.k)
    problems = validate_submission(args.out, expect_k=args.k)
    if problems:
        log.warning("submission validation problems: %s", problems[:5])
        return 1
    log.info("wrote %s (%d queries, top-%d)", args.out, len(results), args.k)
    return 0


def _load_mutable_models(args, log):
    """Segmented (live-updatable) models for serve/update: restore from
    --state-dir where present, wrap the registry index elsewhere.

    Delta segments must build with the SAME BM25/index config as the main
    index or cross-segment scores drift — the build CLI echoes its config
    into the registry manifest; read it back here."""
    import dataclasses as _dc

    from tdr_torch.ckpt import load_segmented, load_sparse_model
    from tdr_torch.rank import SegmentedBM25
    from tdr_torch.utils.config import TdrConfig

    with open(os.path.join(args.index, "manifest.json")) as f:
        manifest = json.load(f)
    cfg_echo = manifest.get("extra", {}).get("config")
    tcfg = (TdrConfig.from_json(json.dumps(cfg_echo)) if cfg_echo
            else TdrConfig())
    state_dir = getattr(args, "state_dir", None)
    models = {}
    if state_dir and os.path.isdir(state_dir):
        from tdr_torch.ckpt import recover_segmented_dir

        recover_segmented_dir(state_dir)   # repair mid-swap crash debris
        for l in sorted(os.listdir(state_dir)):
            p = os.path.join(state_dir, l)
            if l.startswith(".") or not os.path.isdir(p):
                continue   # swap/corrupt debris is dot-prefixed — never state
            try:
                models[l] = load_segmented(p, device=args.device)
            except Exception as e:   # noqa: BLE001 — fall back per lang
                if _device_fault(e):
                    raise
                # PRESERVE the unreadable state (the shutdown save would
                # otherwise overwrite it with a fresh registry wrap and
                # destroy every accumulated update) and fall back
                import time as _time

                quarantine = os.path.join(
                    state_dir, f".{l}.corrupt-{int(_time.time())}")
                os.rename(p, quarantine)
                log.warning(
                    "could not restore %s state (%s); preserved it at %s "
                    "and falling back to the registry index", l, e,
                    quarantine)
        if models:
            log.info("restored mutable state for %s from %s",
                     sorted(models), state_dir)
    # registry languages without saved state wrap fresh (covers the
    # first run, a pre-created empty state dir, and partial state);
    # load per language so restored ones are not loaded twice
    for l in manifest["languages"]:
        if l not in models:
            models[l] = SegmentedBM25(
                main=load_sparse_model(os.path.join(args.index, l),
                                       device=args.device),
                lang=l, bm25=tcfg.bm25, index_cfg=tcfg.index)
    if getattr(args, "spell_correct", False):
        for m in models.values():
            m.main = _dc.replace(m.main, spell_correct=True)
            if m.delta is not None:
                m._rebuild_delta()   # propagate spell into the delta
    return models


def _save_mutable_models(models, state_dir, log):
    from tdr_torch.ckpt import save_segmented

    for l, m in models.items():
        save_segmented(os.path.join(state_dir, l), m)
    log.info("saved mutable state to %s", state_dir)


def _route_add_lang(models, router, text: str, lang: str) -> str:
    """Resolve the language an added document lands in: explicit when it
    names a loaded model, else detection, else a loaded default."""
    if lang in models:
        return lang
    from tdr_torch.text.langid import detect_language

    lang = detect_language(text, default=router.default_lang)
    if lang in models:
        return lang
    return (router.default_lang if router.default_lang in models
            else sorted(models)[0])


def _cmd_serve(args) -> int:
    """Long-running JSON-lines server over stdin/stdout.

    One request per line: {"query": "...", "lang": "en", "k": 10} (lang
    and k optional — unknown languages route via detection).  Requests
    within --window ms coalesce into one padded device batch, so
    interactive clients get single-query latency while bulk pipes get
    batched throughput.  Response per line:
    {"query": ..., "docids": [...], "scores": [...]}.  Results follow
    request order within a batch; malformed lines get an immediate
    {"error": ...} (correlate by the echoed query).
    """
    import select
    import time

    from tdr_torch.ckpt import load_registry
    from tdr_torch.rank import LanguageRouter
    from tdr_torch.utils.trace import log

    t_load = time.perf_counter()
    if not getattr(args, "mutable", False):
        models = _apply_spell(load_registry(args.index, device=args.device),
                          args)
    else:
        models = _load_mutable_models(args, log)
        if getattr(args, "prf", False):
            # store-orchestrated PRF (tdr_torch.rank.segmented): feedback is
            # mined globally across main+delta and the pooled expansion is
            # re-encoded into each segment's vocab, so cross-segment score
            # comparability holds (the old model-level refusal)
            for m in models.values():
                m.prf = True
    router = LanguageRouter(models, query_batch=args.batch)
    log.info("loaded %d models in %.3f s", len(models),
             time.perf_counter() - t_load)
    # warm EVERY bucket for EVERY language before accepting traffic (the
    # first call builds the CUDA kernels and sizes each model's buffers;
    # a first request routed to a cold language would otherwise wait on
    # that mid-stream): the small-batch buckets (1, 8, ...) serve single
    # queries without paying the full padded-batch score matrix; the full
    # batch covers window bursts
    for lang in sorted(models):
        for b in sorted({*router.query_buckets, args.batch}):
            if b <= args.batch:
                router.retrieve(["warmup"] * b, [lang] * b, k=args.k)
    log.info("serving %d models (batch %d, window %.0f ms%s); one JSON per line",
             len(models), args.batch, args.window_ms,
             ", mutable" if getattr(args, "mutable", False) else "")

    def emit(obj):
        sys.stdout.write(json.dumps(obj) + "\n")
        if "error" in obj:
            sys.stdout.flush()   # error-only streams must not sit buffered

    def parse_request(line: str):
        """line → request dict, or None after emitting an error object.
        Any valid-JSON-but-wrong-shape input must NOT kill the server."""
        try:
            r = json.loads(line)
        except json.JSONDecodeError as e:
            emit({"error": str(e)})
            return None
        if isinstance(r, dict) and ("add" in r or "delete" in r):
            if not getattr(args, "mutable", False):
                emit({"error": "server is read-only (start with --mutable)"})
                return None
            if "add" in r:
                a = r["add"]
                if (not isinstance(a, dict)
                        or not isinstance(a.get("docid"), str)
                        or not isinstance(a.get("text"), str)
                        or not isinstance(a.get("lang", ""), str)):
                    emit({"error": "'add' needs string docid and text "
                                   "(optional string lang)"})
                    return None
            else:
                d = r["delete"]
                if isinstance(d, str):
                    r["delete"] = [d]
                elif not (isinstance(d, list)
                          and all(isinstance(x, str) for x in d)):
                    emit({"error": "'delete' must be a docid string or a "
                                   "list of docid strings"})
                    return None
            r["_op"] = "add" if "add" in r else "delete"
            return r
        if not isinstance(r, dict) or not isinstance(r.get("query", ""), str):
            emit({"error": "request must be an object with a string 'query'"})
            return None
        k = r.get("k", args.k)
        if not isinstance(k, int) or isinstance(k, bool) or k < 1:
            emit({"error": "'k' must be a positive integer", "query": r.get("query", "")})
            return None
        lang = r.get("lang")
        if lang is not None and not isinstance(lang, str):
            emit({"error": "'lang' must be a string", "query": r.get("query", "")})
            return None
        # cap k at the warmed k (tdr's rule: its larger k compiles a new
        # top-k mid-stream)
        r["k"] = min(k, args.k)
        return r

    # adds arriving within the batching window are COALESCED per language
    # and applied as one add_documents call (ADVICE r3: every add rebuilds
    # the whole delta segment, so N streamed single adds cost O(N^2)
    # re-encodes — the same pending-adds logic as `tdr-torch update`).
    # Request ordering is preserved: queries buffered before an add are answered
    # on the pre-add state (flush(buf) precedes buffering it), queries
    # after an add see it (flush_adds runs before retrieval), and deletes
    # force the adds down first.
    pending_adds: dict = {}   # lang -> ([toks], [docids])
    compact_hinted: set = set()

    def _compact_hint(lang):
        m = models.get(lang)
        if (lang not in compact_hinted
                and getattr(m, "should_compact", False)):
            compact_hinted.add(lang)
            log.warning(
                "segment store %r hit the merge-policy threshold "
                "(tombstones/delta/truncation) — rebuild the index or run "
                "compact_with() to restore single-segment serving", lang)

    def buffer_add(r):
        a = r["add"]
        try:
            lang = _route_add_lang(models, router, a["text"],
                                   a.get("lang") or "")
            toks = router.preprocessor(a["text"], lang)
        except Exception as e:   # noqa: BLE001 — serve must stay alive
            if _device_fault(e):
                raise
            emit({"error": f"mutation failed: {e}"})
            sys.stdout.flush()
            return
        t, i = pending_adds.setdefault(lang, ([], []))
        t.append(toks)
        i.append(a["docid"])

    def flush_adds():
        if not pending_adds:
            return
        for lang, (toks, ids) in pending_adds.items():
            try:
                models[lang].add_documents(toks, ids)
                log.info("applied %d coalesced adds (%s)", len(ids), lang)
                for d in ids:
                    emit({"added": d, "lang": lang})
                _compact_hint(lang)
            except Exception as e:   # noqa: BLE001
                if _device_fault(e):
                    raise
                emit({"error": f"mutation failed: {e}", "docids": ids})
        pending_adds.clear()
        sys.stdout.flush()

    def apply_delete(r):
        """A failing mutation answers with an error line; it must never
        kill the server."""
        try:
            # positional tombstones: a broadcast delete only marks
            # rows in the language(s) that actually hold the docid
            for m in models.values():
                m.delete_documents(r["delete"])
            emit({"deleted": r["delete"]})
            for lang in models:
                _compact_hint(lang)
        except Exception as e:   # noqa: BLE001 — serve must stay alive
            if _device_fault(e):
                raise
            emit({"error": f"mutation failed: {e}"})
        sys.stdout.flush()

    def flush(buf):
        if not buf:
            # no queries to answer — leave pending adds coalescing (the
            # window loop and shutdown drain them explicitly)
            return
        flush_adds()   # queries buffered after an add must see it
        queries = [r.get("query", "") for r in buf]
        langs = [r.get("lang") for r in buf]
        t0 = time.perf_counter()
        res, scores = router.retrieve_with_scores(queries, langs, k=args.k)
        dt = (time.perf_counter() - t0) * 1e3
        for i, r in enumerate(buf):
            kk = r["k"]
            emit({
                "query": r.get("query", ""),
                "docids": res[i][:kk],
                "scores": [round(float(s), 4)
                           for s in scores[i][:len(res[i][:kk])]],
                "batch_ms": round(dt, 1),
            })
        sys.stdout.flush()
        buf.clear()

    # fd-level buffered reader: select() on the raw fd is only meaningful
    # when WE own the buffer — sys.stdin.readline() drains whole pipe
    # chunks into the TextIOWrapper, making select lie about pending lines
    fd = sys.stdin.fileno()
    pending = bytearray()
    eof = False

    def next_line(timeout):
        """One line (without newline) within ``timeout`` seconds, or None.
        timeout=None blocks until a line or EOF."""
        nonlocal pending, eof
        deadline = None if timeout is None else time.perf_counter() + timeout
        while True:
            nl = pending.find(b"\n")
            if nl >= 0:
                line = pending[:nl].decode("utf-8", "replace")
                del pending[:nl + 1]
                return line
            if eof:
                if pending:
                    line = pending.decode("utf-8", "replace")
                    pending.clear()
                    return line
                return None
            left = None if deadline is None else deadline - time.perf_counter()
            if left is not None and left <= 0:
                return None
            ready, _, _ = select.select([fd], [], [], left)
            if not ready:
                return None
            chunk = os.read(fd, 1 << 16)
            if not chunk:
                eof = True
            else:
                pending.extend(chunk)

    buf = []

    def shutdown() -> int:
        state_dir = getattr(args, "state_dir", None)
        if getattr(args, "mutable", False) and state_dir:
            _save_mutable_models(models, state_dir, log)
        return 0

    def handle(line):
        if not line.strip():
            return
        r = parse_request(line.strip())
        if r is None:
            return
        if r.get("_op") == "add":
            # answer pre-add queries on the pre-add state, then coalesce
            # the add into the window's pending batch
            flush(buf)
            buffer_add(r)
        elif r.get("_op") == "delete":
            # deletes apply in request order: adds + queries go down first
            flush(buf)
            flush_adds()
            apply_delete(r)
        else:
            buf.append(r)

    while True:
        line = next_line(None)
        if line is None:
            flush(buf)
            flush_adds()
            return shutdown()
        handle(line)
        # coalesce: requests already buffered or arriving within the window
        # share one padded device batch (queries) / one delta rebuild (adds)
        deadline = time.perf_counter() + args.window_ms / 1e3
        while len(buf) < args.batch:
            nxt = next_line(max(0.0, deadline - time.perf_counter()))
            if nxt is None:
                break
            handle(nxt)
        flush(buf)
        flush_adds()   # window end: apply + ack the coalesced adds
        if eof and not pending:
            return shutdown()


def _cmd_update(args) -> int:
    """Batch live updates: apply a JSONL of add/delete requests (the serve
    --mutable request schema) to a segmented state dir, without running a
    server.  The registry index itself is never modified — updates
    accumulate in the state dir until a rebuild/compaction.

        tdr-torch update --index idx/ --state-dir live/ --updates updates.jsonl
    """
    from tdr_torch.rank import LanguageRouter
    from tdr_torch.utils.trace import log

    models = _load_mutable_models(args, log)
    router = LanguageRouter(models)   # preprocessor + default_lang routing
    n_add = n_del = n_err = 0
    # coalesce consecutive adds per language (flushed before any delete):
    # each add_documents call rebuilds the whole delta, so per-line adds
    # would be O(N^2) in the batch size
    pending = {}

    def flush_adds():
        nonlocal n_add
        for lang, (toks, ids) in pending.items():
            models[lang].add_documents(toks, ids)
            n_add += len(ids)
        pending.clear()

    with open(args.updates) as f:
        for ln, line in enumerate(f, 1):
            if not line.strip():
                continue
            try:
                r = json.loads(line)
                if "add" in r:
                    a = r["add"]
                    if (not isinstance(a, dict)
                            or not isinstance(a.get("docid"), str)
                            or not isinstance(a.get("text"), str)
                            or not isinstance(a.get("lang", ""), str)):
                        raise ValueError(
                            "'add' needs string docid and text "
                            "(optional string lang)")
                    lang = _route_add_lang(models, router, a["text"],
                                           a.get("lang") or "")
                    toks, ids = pending.setdefault(lang, ([], []))
                    toks.append(router.preprocessor(a["text"], lang))
                    ids.append(a["docid"])
                elif "delete" in r:
                    d = r["delete"]
                    ids = [d] if isinstance(d, str) else d
                    if not (isinstance(ids, list)
                            and all(isinstance(x, str) for x in ids)):
                        raise ValueError(
                            "'delete' must be a docid string or a list "
                            "of docid strings")
                    flush_adds()   # mutations apply in file order
                    for m in models.values():
                        m.delete_documents(ids)
                    n_del += len(ids)
                else:
                    raise ValueError("line must have 'add' or 'delete'")
            except Exception as e:   # noqa: BLE001 — report, keep applying
                if _device_fault(e):
                    raise
                log.warning("updates line %d failed: %s", ln, e)
                n_err += 1
    flush_adds()
    _save_mutable_models(models, args.state_dir, log)
    log.info("applied %d adds, %d deletes (%d errors)", n_add, n_del, n_err)
    return 0 if n_err == 0 else 1


def _cmd_eval(args) -> int:
    from tdr_torch.ckpt import load_registry
    from tdr_torch.data import load_queries
    from tdr_torch.eval import evaluate_retrieval
    from tdr_torch.rank import LanguageRouter

    models = _apply_spell(load_registry(args.index, device=args.device),
                          args)
    queries = load_queries(args.queries)
    if not queries.positive_docs:
        print("error: query file has no positive_docs column", file=sys.stderr)
        return 2
    router = LanguageRouter(models, query_batch=args.batch)
    results = router.retrieve(queries.queries, queries.langs, k=args.k)
    report = evaluate_retrieval(results, queries.positive_docs, queries.langs)
    print(json.dumps(report, indent=2))
    return 0


def _cmd_cascade(args) -> int:
    """Cosine candidate generation + BM25 re-rank
    (cosine_similarity_bm25_reranking.py pipeline)."""
    from tdr_torch.ckpt import load_registry
    from tdr_torch.data import load_queries
    from tdr_torch.eval import evaluate_retrieval, write_submission
    from tdr_torch.rank import CascadeRetriever

    cand = load_registry(args.candidates_index, device=args.device)
    rank = load_registry(args.rerank_index, device=args.device)
    queries = load_queries(args.queries)
    cascade = CascadeRetriever(cand, rank, candidates=args.n_candidates,
                               query_batch=args.batch)
    results = cascade.retrieve(queries.queries, queries.langs, k=args.k)
    if queries.positive_docs:
        print(json.dumps(evaluate_retrieval(results, queries.positive_docs,
                                            queries.langs), indent=2))
    if args.out:
        write_submission(results, args.out, ids=queries.query_ids, k=args.k)
    return 0


def _cmd_retrieve_dense(args) -> int:
    """Dense-embedding retrieval (flat or IVF) from a trained checkpoint."""
    from tdr_torch.ckpt import load_dense_model
    from tdr_torch.data import load_queries
    from tdr_torch.eval import evaluate_retrieval, write_submission
    from tdr_torch.models.dense import build_ivf_index

    dense = load_dense_model(args.index, device=args.device)
    if args.ivf and dense.ivf is None:
        n = dense.flat.n_docs
        emb = dense.flat.embeddings[:n].float()
        if dense.flat.doc_scale is not None:
            # int8 (SQ8) flat checkpoint: dequantize before clustering —
            # raw codes carry a 127/rowmax per-row factor that would
            # distort centroids and inner-product ranking
            emb = emb * dense.flat.doc_scale[:n, None]
            dense.ivf = build_ivf_index(emb, nlist=dense.cfg.ivf_nlist,
                                        dtype="int8", device=args.device)
        else:
            dense.ivf = build_ivf_index(emb, nlist=dense.cfg.ivf_nlist,
                                        device=args.device)
    queries = load_queries(args.queries)
    results = dense.retrieve(queries.queries, k=args.k, use_ivf=args.ivf)
    if queries.positive_docs:
        print(json.dumps(evaluate_retrieval(results, queries.positive_docs,
                                            queries.langs), indent=2))
    if args.out:
        write_submission(results, args.out, ids=queries.query_ids, k=args.k)
    return 0


def _cmd_train(args) -> int:
    """Train the dense dual-encoder retriever on (query, positive, negatives)
    triples and checkpoint encoder + corpus embedding index."""
    from tdr_torch.ckpt import save_dense_model
    from tdr_torch.data import load_corpus, load_queries
    from tdr_torch.models.dense import DenseModel
    from tdr_torch.parallel import make_mesh
    from tdr_torch.train import train_dense_retriever
    from tdr_torch.utils.config import TdrConfig
    from tdr_torch.utils.device import resolve_device
    from tdr_torch.utils.trace import log

    import torch

    cfg = TdrConfig.from_json(open(args.config).read()) if args.config else TdrConfig()
    dcfg = cfg.dense
    corpus = load_corpus(args.corpus)
    train_q = load_queries(args.train)
    mesh = None
    # a mesh only when more than one device of the asked type is visible
    # (make_mesh then takes every CUDA device)
    if (args.mesh and resolve_device(args.device).type == "cuda"
            and torch.cuda.device_count() > 1):
        data, model_p = (int(x) for x in args.mesh.split("x"))
        mesh = make_mesh(data=data, model=model_p)
    model, state, metrics = train_dense_retriever(
        corpus, train_q, dcfg, mesh=mesh, epochs=args.epochs,
        batch_size=args.batch, n_neg=args.negatives, lr=args.lr,
        device=args.device)
    log.info("final training metrics: %s", metrics)
    dense = DenseModel.build(model, dcfg, corpus.texts, corpus.docids,
                             with_ivf=args.ivf)
    save_dense_model(args.out, dense)
    log.info("saved dense model to %s", args.out)
    return 0


def _cmd_validate(args) -> int:
    from tdr_torch.eval import validate_submission

    problems = validate_submission(args.submission, expect_k=args.k)
    if problems:
        print("\n".join(problems))
        return 1
    print("OK")
    return 0


def _cmd_fuse(args) -> int:
    """Reciprocal-rank-fuse finished submission files into one (the
    measured +2-recall ensemble, ARCHITECTURE.md "Engine ensembling").
    Inputs must rank the same query ids; order follows the first input."""
    from tdr_torch.eval import read_submission, validate_submission, write_submission
    from tdr_torch.rank import rrf_fuse
    from tdr_torch.utils.trace import log

    if len(args.inputs) < 2:
        log.error("fuse needs at least two inputs (got %d) — fusing one "
                  "engine is a no-op", len(args.inputs))
        return 1
    ids0 = None
    rankings = []
    for path in args.inputs:
        ids, ranking = read_submission(path)
        if len(set(ids)) != len(ids):
            log.error("%s contains duplicate query ids — aligning by id "
                      "would silently drop rows; fix the input first", path)
            return 1
        if ids0 is None:
            ids0 = ids
        elif ids != ids0:
            if sorted(ids) != sorted(ids0):
                log.error("%s ranks different query ids than %s", path,
                          args.inputs[0])
                return 1
            order = {q: i for i, q in enumerate(ids)}
            ranking = [ranking[order[q]] for q in ids0]
        min_depth = min((len(r) for r in ranking), default=0)
        if min_depth < args.k:
            log.error("%s ranks only %d docs/query but --k is %d — the "
                      "fused file would fail validation; re-retrieve "
                      "deeper or lower --k", path, min_depth, args.k)
            return 1
        rankings.append(ranking)
    try:
        weights = ([float(w) for w in args.weights.split(",")]
                   if args.weights else None)
    except ValueError:
        log.error("--weights must be comma-separated numbers, got %r",
                  args.weights)
        return 1
    if weights and len(weights) != len(rankings):
        log.error("need one weight per input (%d inputs, %d weights)",
                  len(rankings), len(weights))
        return 1
    fused = rrf_fuse(rankings, k=args.k, rrf_k=args.rrf_k, weights=weights)
    write_submission(fused, args.out, ids=ids0, k=args.k)
    problems = validate_submission(args.out, expect_k=args.k)
    if problems:
        log.warning("fused submission validation problems: %s", problems[:5])
        return 1
    log.info("fused %d engines over %d queries -> %s",
             len(rankings), len(ids0 or []), args.out)
    return 0


def _cmd_synth(args) -> int:
    from tdr_torch.data import synthetic_corpus, SyntheticSpec

    corpus, queries = synthetic_corpus(
        SyntheticSpec(n_docs=args.docs, n_queries=args.queries, seed=args.seed))
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "corpus.json"), "w") as f:
        json.dump([{"docid": d, "text": t, "lang": l}
                   for d, t, l in zip(corpus.docids, corpus.texts, corpus.langs)], f)
    import csv

    with open(os.path.join(args.out, "dev.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["query_id", "query", "positive_docs", "lang"])
        for qid, q, p, l in zip(queries.query_ids, queries.queries,
                                queries.positive_docs, queries.langs):
            w.writerow([qid, q, p, l])
    # train.csv with sampled negatives (the train split schema, SURVEY.md §0)
    import numpy as np

    rng = np.random.RandomState(args.seed + 1)
    with open(os.path.join(args.out, "train.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["query_id", "query", "positive_docs", "negative_docs", "lang"])
        for qid, q, p, l in zip(queries.query_ids, queries.queries,
                                queries.positive_docs, queries.langs):
            pool = [d for d in corpus.docids if d != p]
            negs = [pool[i] for i in rng.choice(len(pool), size=min(2, len(pool)),
                                                replace=False)]
            w.writerow([qid, q, p, str(negs), l])
    print(f"wrote {args.out}/corpus.json ({args.docs} docs), dev.csv and "
          f"train.csv ({args.queries} queries)")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tdr-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default="cuda",
                        help="torch device the indexes, models and kernels "
                             "run on (default cuda; raises without CUDA "
                             "unless --device cpu)")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add(name, **kw):
        return sub.add_parser(name, parents=[common], **kw)

    b = add("build", help="build per-language index registry")
    b.add_argument("--head-budget-gb", type=float, default=None,
                   dest="head_budget_gb",
                   help="TOTAL dense-head budget waterfilled across "
                        "languages (full-vocab coverage saturates a "
                        "language and frees the rest); default: the "
                        "config value (4 GiB)")
    b.add_argument("--head-dtype", default=None, dest="head_dtype",
                   choices=["float32", "bfloat16", "int8"],
                   help="dense-head storage dtype; int8 scalar-quantizes "
                        "per doc column (FAISS SQ8 analogue: half the bf16 "
                        "HBM bytes, 2x MXU rate, ~0.4%% per-entry rounding; "
                        "tail + merge stay exact); default: the config "
                        "value (bfloat16)")
    b.add_argument("--corpus", required=True)
    b.add_argument("--out", required=True)
    b.add_argument("--model", choices=["bm25", "cosine"], default="bm25")
    b.add_argument("--config", default=None, help="TdrConfig json")
    b.add_argument("--no-native", action="store_true")
    b.set_defaults(fn=_cmd_build)

    r = add("retrieve", help="retrieve top-k, write submission.csv")
    r.add_argument("--index", required=True)
    r.add_argument("--queries", required=True)
    r.add_argument("--out", default="submission.csv")
    r.add_argument("--k", type=int, default=10)
    r.add_argument("--batch", type=int, default=256)
    r.add_argument("--spell-correct", action="store_true",
                   help="repair out-of-vocabulary query terms by trigram vocabulary matching (tdr_torch.text.spell) before scoring")
    r.add_argument("--prf", action="store_true",
                   help="RM3 pseudo-relevance feedback: mine the first pass's top docs for expansion terms, re-score once (tdr_torch.rank.feedback)")
    r.set_defaults(fn=_cmd_retrieve)

    e = add("eval", help="recall@k / mrr@k report on labeled queries")
    e.add_argument("--index", required=True)
    e.add_argument("--queries", required=True)
    e.add_argument("--k", type=int, default=10)
    e.add_argument("--batch", type=int, default=256)
    e.add_argument("--spell-correct", action="store_true",
                   help="repair out-of-vocabulary query terms by trigram vocabulary matching (tdr_torch.text.spell) before scoring")
    e.add_argument("--prf", action="store_true",
                   help="RM3 pseudo-relevance feedback: mine the first pass's top docs for expansion terms, re-score once (tdr_torch.rank.feedback)")
    e.set_defaults(fn=_cmd_eval)

    fu = add(
        "fuse", help="reciprocal-rank-fuse submission files (ensemble)")
    fu.add_argument("--inputs", nargs="+", required=True,
                    help="two or more submission.csv files over the same "
                         "query ids (either write_submission format)")
    fu.add_argument("--out", default="fused.csv")
    fu.add_argument("--k", type=int, default=10)
    fu.add_argument("--rrf-k", type=int, default=60, dest="rrf_k",
                    help="RRF constant (Cormack et al.: 60)")
    fu.add_argument("--weights", default=None,
                    help="comma-separated per-engine weights, e.g. 1,2")
    fu.set_defaults(fn=_cmd_fuse)

    c = add("cascade", help="cosine candidates -> BM25 re-rank")
    c.add_argument("--candidates-index", required=True, help="cosine registry")
    c.add_argument("--rerank-index", required=True, help="bm25 registry")
    c.add_argument("--queries", required=True)
    c.add_argument("--out", default=None)
    c.add_argument("--k", type=int, default=10)
    c.add_argument("--n-candidates", type=int, default=200)
    c.add_argument("--batch", type=int, default=128)
    c.set_defaults(fn=_cmd_cascade)

    rd = add("retrieve-dense", help="dense flat/IVF retrieval")
    rd.add_argument("--index", required=True, help="dense checkpoint dir")
    rd.add_argument("--queries", required=True)
    rd.add_argument("--out", default=None)
    rd.add_argument("--k", type=int, default=10)
    rd.add_argument("--ivf", action="store_true")
    rd.set_defaults(fn=_cmd_retrieve_dense)

    t = add("train", help="train the dense dual-encoder retriever")
    t.add_argument("--corpus", required=True)
    t.add_argument("--train", required=True, help="train.csv with positive/negative docs")
    t.add_argument("--out", required=True)
    t.add_argument("--config", default=None)
    t.add_argument("--epochs", type=int, default=3)
    t.add_argument("--batch", type=int, default=64)
    t.add_argument("--negatives", type=int, default=2)
    t.add_argument("--lr", type=float, default=3e-4)
    t.add_argument("--mesh", default=None, help="DATAxMODEL, e.g. 4x2")
    t.add_argument("--ivf", action="store_true")
    t.set_defaults(fn=_cmd_train)

    sv = add("serve", help="JSON-lines retrieval server on stdin/stdout")
    sv.add_argument("--index", required=True)
    sv.add_argument("--k", type=int, default=10)
    sv.add_argument("--batch", type=int, default=64)
    sv.add_argument("--window-ms", type=float, default=5.0, dest="window_ms",
                    help="coalescing window: requests arriving within this "
                         "many ms share one device batch")
    sv.add_argument("--spell-correct", action="store_true",
                    help="repair out-of-vocabulary query terms by trigram "
                         "vocabulary matching (tdr_torch.text.spell) before scoring")
    sv.add_argument("--prf", action="store_true",
                    help="RM3 pseudo-relevance feedback (tdr_torch.rank.feedback); "
                         "with --mutable the segmented store orchestrates it "
                         "globally (feedback merged across main+delta, "
                         "pooled expansion re-encoded per segment — "
                         "tdr_torch.rank.segmented)")
    sv.add_argument("--state-dir", default=None, dest="state_dir",
                    help="with --mutable: restore segmented state from this "
                         "directory on startup (if it exists) and save it "
                         "there on clean shutdown")
    sv.add_argument("--mutable", action="store_true",
                    help="accept live updates: {\"add\": {\"docid\", "
                         "\"text\", \"lang\"?}} and {\"delete\": docid(s)} "
                         "request lines (Lucene-style segments, "
                         "tdr_torch.rank.segmented); applied in request order")
    sv.set_defaults(fn=_cmd_serve)

    u = add("update", help="apply a JSONL of add/delete "
                                      "requests to a segmented state dir")
    u.add_argument("--index", required=True)
    u.add_argument("--state-dir", required=True, dest="state_dir")
    u.add_argument("--updates", required=True,
                   help="JSONL file; one serve-style add/delete per line")
    u.set_defaults(fn=_cmd_update)

    v = add("validate", help="validate a submission csv")
    v.add_argument("--submission", required=True)
    v.add_argument("--k", type=int, default=10)
    v.set_defaults(fn=_cmd_validate)

    s = add("synth", help="generate a synthetic corpus + dev set")
    s.add_argument("--docs", type=int, default=1000)
    s.add_argument("--queries", type=int, default=100)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--out", default="data")
    s.set_defaults(fn=_cmd_synth)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
