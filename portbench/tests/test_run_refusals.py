"""The command refuses to measure where it cannot: no CUDA device (it never
falls back to the CPU), or a checkout that holds only the benchmark."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import harness

ARGS = ["-m", "portbench.run", "--workload", "posetrack_eval_b30", "--seed", "3000000017",
        "--seconds", "1", "--trace", "0"]


def _run(cwd):
    env = dict(os.environ, PYTHONPATH=str(cwd), CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, *ARGS], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_without_a_card_it_prints_no_result(no_card):
    done = _run(harness.ROOT)
    assert done.returncode != 0 and done.stdout.strip() == ""
    assert "CUDA device" in done.stderr


def test_the_benchmark_alone_prints_no_result(tmp_path, no_card):
    shutil.copy(harness.SPEC, tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.PACKAGE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    done = _run(tmp_path)
    assert done.returncode != 0 and done.stdout.strip() == ""
