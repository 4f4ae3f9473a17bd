"""The result line and the refusals the contract asks for."""

import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

from gcbench import harness
from gcbench.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_last_line_has_the_contract_keys_and_compared_last(tiny_root):
    result, compared = tiny.run(tiny_root, "tiny_rest.train", seed=9)
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        harness.finish(result, compared)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line) == KEYS + ["compared"]
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(line["compared"]) == set(compared)
    last = err.getvalue().strip().splitlines()[-len(compared):]
    assert all(s.startswith("compared ") for s in last)


def test_a_traced_line_adds_breakdown_and_device_times(tiny_root):
    result, compared = tiny.run(tiny_root, "tiny_bldg.train", seed=9,
                                trace=True)
    assert list(result) == KEYS + ["breakdown"]
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def _run(args, cwd):
    return subprocess.run([sys.executable, "gcbench/run.py", *args],
                          capture_output=True, text=True, cwd=cwd,
                          timeout=300, env=dict(os.environ,
                                                CUDA_VISIBLE_DEVICES=""))


def test_no_card_no_result():
    out = _run(["--workload", "bldg.train", "--seed", "1", "--seconds", "1",
                "--trace", "0"], tiny.REPO)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_only_the_benchmark_files_no_result(tmp_path):
    import shutil

    shutil.copy(os.path.join(tiny.REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(tiny.REPO, "gcbench"), tmp_path / "gcbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(["--workload", "rest.frame", "--seed", "1", "--seconds", "1",
                "--trace", "0"], str(tmp_path))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
