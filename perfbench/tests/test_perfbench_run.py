"""The command as the benchmark runs it: without a card it refuses and
prints no result; on a card (marked `chip`) one short run prints its line,
and a directory holding only BENCHMARK.json and perfbench/ cannot run."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from perfbench import core

CMD = [sys.executable, "perfbench/run.py", "--workload", "amcl_2d_store.track",
       "--seed", str(2 ** 31 + 3), "--seconds", "2", "--trace", "0"]


def _run(cwd, timeout=600):
    return subprocess.run(CMD, cwd=cwd, capture_output=True, text=True, timeout=timeout,
                          env=dict(os.environ, PYTHONPATH=""))


def test_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run(core.ROOT)
    assert out.returncode == 2 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


@pytest.mark.chip
def test_one_short_run_on_the_card(card):
    out = _run(core.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert {"scan_ms_p95", "scans_per_s", "setup_s"} <= set(res["metrics"])
    assert list(res)[-1] == "checks"
    assert out.stderr.strip().splitlines()[-1].startswith("check ")


@pytest.mark.chip
def test_the_benchmark_alone_cannot_run(card, tmp_path):
    shutil.copy(os.path.join(core.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(core.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
