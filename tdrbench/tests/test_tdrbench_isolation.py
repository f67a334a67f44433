"""What a run may load and where it may run: no JAX and no JAX package in
the process, nothing of the program in the reference, no result without a
card or without the program."""

import json
import os
import shutil
import subprocess
import sys
import types

import pytest

from tdrbench.harness import common

CMD = [sys.executable, "tdrbench/run.py", "--workload", "bm25-batch-docmix",
       "--seed", "1", "--seconds", "1", "--trace", "0"]


def clean_env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


@pytest.mark.parametrize("name,bad", [("tdr", True), ("tdr.ops.score", True),
                                      ("jax", True), ("jaxlib.xla_client", True),
                                      ("flax.linen", True), ("tdr_torch", False),
                                      ("tdr_torch.ops", False),
                                      ("tdrbench", False)])
def test_import_check_compares_whole_top_level_names(monkeypatch, name, bad):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    if bad:
        with pytest.raises(common.BenchError):
            common.import_check("test")
    else:
        common.import_check("test")


def test_reference_reaches_nothing_of_the_program():
    import tdrbench.reference.bm25  # noqa: F401
    import tdrbench.reference.encoder  # noqa: F401
    import tdrbench.reference.hashing  # noqa: F401
    import tdrbench.reference.text  # noqa: F401

    assert common.reference_leaks() == []


def test_reference_holding_the_program_is_found(monkeypatch):
    import tdrbench.reference.text as t

    fake = types.ModuleType("tdr_torch.text.fast")
    monkeypatch.setattr(t, "fast", fake, raising=False)
    assert common.reference_leaks()


def test_no_result_without_the_program(tmp_path):
    shutil.copy(os.path.join(common.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(common.BENCH_DIR, tmp_path / "tdrbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(CMD, cwd=tmp_path, capture_output=True, text=True,
                         env=clean_env(), timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(CMD, cwd=common.ROOT, capture_output=True, text=True,
                         env=clean_env(), timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
    assert "cuda" in out.stderr.lower()


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  common.benchmark()["workloads"]])
def test_cell_runs_correct_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "tdrbench/run.py", "--workload", cell,
                          "--seed", str(2**31 + 99), "--seconds", "3",
                          "--trace", "0"], cwd=common.ROOT, capture_output=True,
                         text=True, env=clean_env(), timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.splitlines()[-1])["correct"]
