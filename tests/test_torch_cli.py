"""The port's CLI (``python -m tdr_torch.cli ... --device cpu``) against
``tdr.cli`` on the same files, on CPU.

Every subcommand but ``serve`` runs in-process through each package's
``main(argv)``; ``serve`` runs as a subprocess of each CLI, each with its
own ``timeout=``, on the same request script.  Held:

* ``synth``: the three files byte-equal; ``fuse``: the fused file
  byte-equal and the same exit code on each rejection; ``validate``: the
  same problems and exit code; ``eval``: the same metrics;
* ``build``: each package's registry retrieved by the other's CLI, the
  submissions equal but for near-ties (scores within rtol 1e-5 of the
  rank they swap with, from the port's router at k = 20); ``cascade`` and
  ``retrieve-dense`` the same way, the latter on a dense checkpoint that
  the port's ``train`` wrote and ``tdr`` loads;
* ``serve`` (plain with malformed and bad requests; ``--mutable --prf
  --state-dir`` with adds, deletes and a restart): the same response
  lines, docids equal but for near-ties, scores (rounded to 4 places by
  both) within 1e-4, ``batch_ms`` not compared;
* ``update``: the same exit code and the same saved segment state.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from tests.torch_threads import torch

from tdr import cli as jcli  # noqa: E402
from tdr_torch import cli as tcli  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUDGET = "0.0005"                 # GiB: heads and tails in most languages
DEVICE_CMDS = {"build", "retrieve", "eval", "cascade", "retrieve-dense",
               "train", "serve", "update"}


def _run(pkg, argv):
    """(exit code, stdout) of one CLI call in this process."""
    if pkg == "port" and argv[0] in DEVICE_CMDS:
        argv = [argv[0], "--device", "cpu"] + argv[1:]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = (jcli if pkg == "tdr" else tcli).main([str(a) for a in argv])
    return rc, out.getvalue()


def _read_sub(path):
    from tdr_torch.eval import read_submission

    return read_submission(str(path))


def _port_reference(index, queries, k=20):
    """The port router's lists and scores at depth k on a registry."""
    from tdr_torch.ckpt import load_registry
    from tdr_torch.data import load_queries
    from tdr_torch.rank import LanguageRouter

    qs = load_queries(str(queries))
    router = LanguageRouter(load_registry(str(index), device="cpu"),
                            query_batch=256)
    docs, scores = router.retrieve_with_scores(qs.queries, qs.langs, k=k)
    return docs, [np.asarray(s, np.float64) for s in scores]


def _same_but_near_ties(got, ref_docs, ref_scores, k=10):
    """Each list equals the reference's top k, except that a rank may hold
    another doc whose score is within rtol 1e-5 of that rank's."""
    assert len(got) == len(ref_docs)
    swaps = 0
    for g, rd, rs in zip(got, ref_docs, ref_scores):
        assert len(g) == min(k, len(rd))
        score = dict(zip(rd, rs))
        for i, d in enumerate(g):
            if d == rd[i]:
                continue
            swaps += 1
            assert d in score, (g, rd[:k])
            assert abs(score[d] - rs[i]) <= 1e-5 * abs(rs[i]) + 1e-6, (d, i)
    return swaps


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Both packages' synth output, each package's BM25 and cosine
    registries built from tdr's files."""
    tmp = tmp_path_factory.mktemp("cli")
    for pkg in ("tdr", "port"):
        rc, _ = _run(pkg, ["synth", "--docs", 400, "--queries", 60,
                           "--seed", 3, "--out", tmp / f"{pkg}_data"])
        assert rc == 0
    data = tmp / "tdr_data"
    for pkg in ("tdr", "port"):
        for model in ("bm25", "cosine"):
            rc, _ = _run(pkg, ["build", "--corpus", data / "corpus.json",
                               "--out", tmp / f"{pkg}_{model}",
                               "--model", model, "--head-budget-gb", BUDGET])
            assert rc == 0
    return tmp


def test_synth_byte_equal(world):
    for name in ("corpus.json", "dev.csv", "train.csv"):
        a = (world / "tdr_data" / name).read_bytes()
        assert a == (world / "port_data" / name).read_bytes(), name


@pytest.mark.parametrize("index", ["tdr_bm25", "port_bm25"])
@pytest.mark.parametrize("flags", [[], ["--prf"], ["--spell-correct"]])
def test_retrieve_either_registry_with_either_cli(world, index, flags):
    """Each package's registry through both CLIs: the four submissions
    equal but for near-ties."""
    dev = world / "tdr_data" / "dev.csv"
    subs = {}
    for pkg in ("tdr", "port"):
        out = world / f"sub_{pkg}_{index}_{'-'.join(flags)}.csv"
        rc, _ = _run(pkg, ["retrieve", "--index", world / index, "--queries",
                           dev, "--out", out] + flags)
        assert rc == 0
        subs[pkg] = _read_sub(out)
    assert subs["tdr"][0] == subs["port"][0]          # query ids, in order
    if flags:
        assert subs["tdr"][1] == subs["port"][1]
        return
    ref_docs, ref_scores = _port_reference(world / index, dev)
    for pkg in ("tdr", "port"):
        _same_but_near_ties(subs[pkg][1], ref_docs, ref_scores)


def test_eval_metrics_equal(world):
    dev = world / "tdr_data" / "dev.csv"
    reports = {}
    for pkg in ("tdr", "port"):
        rc, out = _run(pkg, ["eval", "--index", world / f"{pkg}_bm25",
                             "--queries", dev])
        assert rc == 0
        reports[pkg] = json.loads(out)
    assert reports["tdr"] == reports["port"]
    assert reports["port"]["recall@10"] > 0.9


def test_eval_without_positives_exits_2(world, capsys):
    path = world / "no_pos.csv"
    path.write_text("query_id,query,lang\nq0,hello world,en\n")
    for pkg in ("tdr", "port"):
        rc, out = _run(pkg, ["eval", "--index", world / f"{pkg}_bm25",
                             "--queries", path])
        assert rc == 2 and out == ""
        assert "no positive_docs column" in capsys.readouterr().err


def _two_submissions(world):
    dev = world / "tdr_data" / "dev.csv"
    paths = []
    for flags, name in (([], "a.csv"), (["--k", "20"], "b.csv")):
        out = world / f"fuse_in_{name}"
        rc, _ = _run("tdr", ["retrieve", "--index", world / "tdr_bm25",
                             "--queries", dev, "--out", out] + flags)
        assert rc in (0, 1)                  # k = 20 may validate short
        paths.append(out)
    return paths


def test_fuse_byte_equal(world):
    a, b = _two_submissions(world)
    outs = {}
    for pkg in ("tdr", "port"):
        out = world / f"fused_{pkg}.csv"
        rc, _ = _run(pkg, ["fuse", "--inputs", a, b, "--out", out,
                           "--weights", "1,2", "--rrf-k", 30])
        assert rc == 0
        outs[pkg] = out.read_bytes()
    assert outs["tdr"] == outs["port"]


@pytest.mark.parametrize("case", ["single", "mismatched", "weights",
                                  "n_weights", "shallow", "duplicate"])
def test_fuse_rejections_match(world, case):
    a, b = _two_submissions(world)
    lines = a.read_text().splitlines()
    extra = []
    if case == "single":
        inputs = [a]
    elif case == "mismatched":
        other = world / "fuse_other.csv"
        other.write_text("\n".join(lines[:-1] + ["zz-x,\"['d']\""]) + "\n")
        inputs = [a, other]
    elif case in ("weights", "n_weights"):
        inputs = [a, b]
        extra = ["--weights", "1,x" if case == "weights" else "1,2,3"]
    elif case == "shallow":
        inputs = [a, b]
        extra = ["--k", 30]
    else:
        dup = world / "fuse_dup.csv"
        dup.write_text("\n".join(lines + [lines[1]]) + "\n")
        inputs = [a, dup]
    for pkg in ("tdr", "port"):
        out = world / f"fused_{case}_{pkg}.csv"
        rc, _ = _run(pkg, ["fuse", "--inputs", *inputs, "--out", out] + extra)
        assert rc == 1, (pkg, case)
        assert not out.exists()


@pytest.mark.parametrize("case", ["good", "bad", "wide_bad"])
def test_validate_same_problems_and_code(world, case):
    path = world / f"validate_{case}.csv"
    if case == "good":
        _run("tdr", ["retrieve", "--index", world / "tdr_bm25", "--queries",
                     world / "tdr_data" / "dev.csv", "--out", path])
    elif case == "bad":
        path.write_text("id,docids\nq1,\"['a', 'b']\"\nq1,\"['a', 'a', 'b']\"\n"
                        "q2,notalist(\nq3\n")
    else:
        path.write_text("id,doc_1,doc_2\nq1,a,b\nq1,a\nq2,c,c\n")
    got = {pkg: _run(pkg, ["validate", "--submission", path, "--k", 2
                           if case == "wide_bad" else 10])
           for pkg in ("tdr", "port")}
    assert got["tdr"] == got["port"]
    assert got["port"][0] == (0 if case == "good" else 1)


def test_cascade_lists_and_metrics_equal(world):
    dev = world / "tdr_data" / "dev.csv"
    res = {}
    for pkg in ("tdr", "port"):
        out = world / f"cascade_{pkg}.csv"
        rc, printed = _run(pkg, [
            "cascade", "--candidates-index", world / f"{pkg}_cosine",
            "--rerank-index", world / f"{pkg}_bm25", "--queries", dev,
            "--out", out, "--n-candidates", 50])
        assert rc == 0
        res[pkg] = (json.loads(printed), _read_sub(out))
    assert res["tdr"][0] == res["port"][0]
    assert res["tdr"][1] == res["port"][1]


def _tiny_config(world):
    from tdr_torch.utils.config import TdrConfig

    cfg = json.loads(TdrConfig().to_json())
    # an f32 encoder: the two packages' query embeddings then agree to
    # f32 rounding, and a swapped rank is a near-tie at rtol 1e-5
    cfg["dense"].update(vocab_size=500, dim=32, depth=1, heads=2,
                        max_len=16, ivf_nlist=4, ivf_nprobe=2,
                        dtype="float32")
    path = world / "tiny.json"
    path.write_text(json.dumps(cfg))
    return path


def test_train_checkpoint_loads_in_tdr_and_retrieve_dense_matches(world):
    """The port's ``train`` writes a dense checkpoint; ``tdr`` loads it and
    both CLIs' ``retrieve-dense`` (flat) give the same lists but for
    near-ties; the port's ``--ivf`` path runs on it."""
    from tdr.ckpt import load_dense_model as jload
    from tdr_torch.ckpt import load_dense_model
    from tdr_torch.data import load_queries
    from tdr_torch.models.dense import flat_search

    data = world / "tdr_data"
    ckpt = world / "dense_port"
    rc, _ = _run("port", ["train", "--corpus", data / "corpus.json",
                          "--train", data / "train.csv", "--out", ckpt,
                          "--config", _tiny_config(world), "--epochs", 1,
                          "--batch", 8, "--mesh", "2x1"])
    assert rc == 0
    jd = jload(str(ckpt))
    td = load_dense_model(str(ckpt), device="cpu")
    assert jd.docids == td.docids and jd.cfg.dim == 32
    subs, printed = {}, {}
    for pkg in ("tdr", "port"):
        out = world / f"dense_{pkg}.csv"
        rc, printed[pkg] = _run(pkg, ["retrieve-dense", "--index", ckpt,
                                      "--queries", data / "dev.csv",
                                      "--out", out])
        assert rc == 0
        subs[pkg] = _read_sub(out)[1]
    qs = load_queries(str(data / "dev.csv"))
    vals, rows = flat_search(td.flat, td.encode_queries(qs.queries), top_k=20)
    ref_docs = [[td.docids[r] for r in row] for row in rows.tolist()]
    ref_scores = [np.asarray(v, np.float64) for v in vals.tolist()]
    for pkg in ("tdr", "port"):
        _same_but_near_ties(subs[pkg], ref_docs, ref_scores)
    rc, _ = _run("port", ["retrieve-dense", "--index", ckpt, "--queries",
                          data / "dev.csv", "--out", world / "ivf.csv",
                          "--ivf"])
    assert rc == 0 and len(_read_sub(world / "ivf.csv")[1]) == 60


def test_update_same_state_and_code(world):
    reqs = world / "updates.jsonl"
    reqs.write_text("\n".join([
        json.dumps({"add": {"docid": "new-en", "text": "zebra quartz "
                            "xylophone harbour", "lang": "en"}}),
        json.dumps({"add": {"docid": "new-de", "text": "Die Zebras "
                            "spielen Xylophon im Hafen", "lang": "de"}}),
        json.dumps({"delete": ["doc-en-3", "doc-de-1"]}),
        json.dumps({"add": {"docid": 5, "text": "bad"}}),
        "not json", ""]) + "\n")
    for pkg in ("tdr", "port"):
        rc, _ = _run(pkg, ["update", "--index", world / f"{pkg}_bm25",
                           "--state-dir", world / f"live_{pkg}",
                           "--updates", reqs])
        assert rc == 1                      # two bad lines
    langs = sorted(os.listdir(world / "live_tdr"))
    assert langs == sorted(os.listdir(world / "live_port"))
    for lang in langs:
        a, b = (json.loads((world / f"live_{p}" / lang / "segments.json")
                           .read_text()) for p in ("tdr", "port"))
        a.pop("format_version"), b.pop("format_version")
        assert a == b, lang
    seg = json.loads((world / "live_port" / "en" / "segments.json")
                     .read_text())
    assert seg["delta_ids"] == ["new-en"] and "doc-en-3" in seg["deleted"]


# -- serve, as subprocesses -------------------------------------------------------

def _serve(pkg, index, requests, flags=()):
    mod = "tdr.cli" if pkg == "tdr" else "tdr_torch.cli"
    argv = [sys.executable, "-m", mod, "serve", "--index", str(index),
            "--k", "5", "--batch", "8", *map(str, flags)]
    if pkg == "port":
        argv[4:4] = ["--device", "cpu"]
    # one string-hash seed for both servers: a live add's delta segment
    # numbers its terms in set order, and --prf breaks ties between
    # expansion terms by term id (the same in both packages, per seed)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONHASHSEED="0")
    return subprocess.Popen(argv, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            env=env, cwd=REPO), requests


def _answers(procs, timeout=300):
    """Feed each server its script, wait (with a timeout) and parse."""
    out = []
    for p, requests in procs:
        try:
            stdout, stderr = p.communicate(
                "".join(json.dumps(r) + "\n" if not isinstance(r, str)
                        else r + "\n" for r in requests).encode(),
                timeout=timeout)
        finally:
            if p.poll() is None:
                p.kill()
        assert p.returncode == 0, stderr.decode()[-2000:]
        out.append([json.loads(l) for l in stdout.decode().splitlines()
                    if l.strip()])
    return out


def _same_answers(tdr_lines, port_lines):
    assert len(tdr_lines) == len(port_lines)
    for a, b in zip(tdr_lines, port_lines):
        a.pop("batch_ms", None), b.pop("batch_ms", None)
        assert a.keys() == b.keys(), (a, b)
        if "scores" not in a:
            assert a == b
            continue
        assert a["query"] == b["query"]
        np.testing.assert_allclose(b["scores"], a["scores"], atol=1e-4,
                                   err_msg=f"{a} {b}")
        last = len(a["docids"]) - 1
        for i, (x, y) in enumerate(zip(a["docids"], b["docids"])):
            if x != y:        # a swap inside a tie (the last rank's partner
                tied = [s for s in a["scores"]          # may lie beyond k)
                        if abs(s - a["scores"][i]) <= 1e-4]
                assert len(tied) > 1 or i == last, (a, b)


@pytest.fixture(scope="module")
def en_world(tmp_path_factory):
    """A one-language registry for each package (serve warms every
    language at every bucket)."""
    from tdr.data import SyntheticSpec, synthetic_corpus

    tmp = tmp_path_factory.mktemp("serve")
    corpus, queries = synthetic_corpus(SyntheticSpec(
        n_docs=300, n_queries=12, seed=3, langs=("en",),
        ref_proportions=False))
    with open(tmp / "corpus.json", "w") as f:
        json.dump([{"docid": d, "text": t, "lang": l} for d, t, l in
                   zip(corpus.docids, corpus.texts, corpus.langs)], f)
    for pkg in ("tdr", "port"):
        rc, _ = _run(pkg, ["build", "--corpus", tmp / "corpus.json",
                           "--out", tmp / f"{pkg}_idx", "--head-budget-gb",
                           BUDGET])
        assert rc == 0
    return tmp, list(queries.queries)


def test_serve_plain_and_mutable_restart_match(en_world):
    tmp, qs = en_world
    plain = ([{"query": q, "lang": "en", "k": 5} for q in qs[:4]]
             + ["garbage line", {"query": qs[4]}, {"query": qs[5], "k": 0},
                {"query": qs[6], "lang": 3}, {"add": {"docid": "x",
                                                     "text": "y"}},
                [1, 2], {"query": qs[7], "k": 3}])
    add = {"add": {"docid": "live-1", "text": "unicornium quasar "
                   "zeppelin", "lang": "en"}}
    run1 = ([{"query": qs[0]}, add, {"query": "unicornium zeppelin"},
             {"add": {"docid": "live-2", "text": "unicornium marmalade"}},
             {"delete": "live-1"}, {"query": "unicornium"},
             {"delete": 7}, "{broken", {"query": qs[1], "k": 2}])
    run2 = [{"query": "unicornium marmalade"}, {"query": "zeppelin quasar"},
            {"query": qs[2]}]
    procs = []
    for pkg in ("tdr", "port"):
        procs.append(_serve(pkg, tmp / f"{pkg}_idx", plain))
        procs.append(_serve(pkg, tmp / f"{pkg}_idx", run1,
                            ["--mutable", "--prf", "--state-dir",
                             tmp / f"state_{pkg}"]))
    j_plain, j_run1, t_plain, t_run1 = _answers(procs)
    procs = [_serve(pkg, tmp / f"{pkg}_idx", run2,
                    ["--mutable", "--prf", "--state-dir",
                     tmp / f"state_{pkg}"]) for pkg in ("tdr", "port")]
    j_run2, t_run2 = _answers(procs)
    for a, b in ((j_plain, t_plain), (j_run1, t_run1), (j_run2, t_run2)):
        _same_answers(a, b)
    # the port's answers carry what the script asks for
    assert sum("error" in r for r in t_plain) == 5
    assert [r for r in t_run1 if "added" in r] == [
        {"added": "live-1", "lang": "en"}, {"added": "live-2", "lang": "en"}]
    found = [r for r in t_run1 if r.get("query") == "unicornium zeppelin"]
    assert found[0]["docids"][0] == "live-1"
    after = [r for r in t_run1 if r.get("query") == "unicornium"][0]
    assert "live-1" not in after["docids"] and "live-2" in after["docids"]
    assert t_run2[0]["docids"][0] == "live-2"
    assert "live-1" not in t_run2[1]["docids"]
