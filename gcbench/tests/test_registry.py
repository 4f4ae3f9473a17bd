"""The registry: every cell of ``BENCHMARK.json`` finds its configuration,
traffic, limits and metric readers by name, and a cell added as files
alone (the tiny throwaway benchmark) runs end to end on the CPU with
the program and the reference agreeing exactly."""

import json
import os

import pytest

from gcbench import harness, inputs
from gcbench.kinds import kind as load_kind
from gcbench.tests import tiny

BENCH = json.load(open(os.path.join(tiny.REPO, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_files(name):
    cell = harness.find_cell(tiny.REPO, name)
    assert cell.config["name"] == cell.workload["config"]
    gc = os.path.join(tiny.REPO, "gcbench")
    assert os.path.exists(os.path.join(gc, "kinds",
                                       cell.traffic["kind"] + ".py"))
    assert callable(load_kind(cell.traffic["kind"]).run)
    if "sampler" in cell.traffic:
        assert os.path.exists(os.path.join(gc, "samplers",
                                           cell.traffic["sampler"] + ".py"))
        assert callable(inputs.sampler(cell.traffic["sampler"]))
    assert cell.limits
    for m in cell.per_layer:
        reader = harness.load_reader(cell.metric_file(m["name"]))
        assert callable(reader.read)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer


def test_every_metric_has_a_reader_and_every_config_a_file():
    gc = os.path.join(tiny.REPO, "gcbench")
    for m in BENCH["per_layer"]:
        assert os.path.exists(os.path.join(gc, "metrics", m["name"] + ".py"))
    for c in BENCH["configs"]:
        conf = json.load(open(os.path.join(tiny.REPO, c["file"])))
        assert conf["name"] == c["name"]
        for comp in conf["companions"]:
            assert comp in {x["name"] for x in BENCH["configs"]}


@pytest.mark.parametrize("name,trace", [
    ("tiny_rest.train", False), ("tiny_bldg.train", True),
    ("tiny_rest.frame", True), ("tiny_city.frame", False)])
def test_a_cell_added_as_files_runs(tiny_root, name, trace):
    result, compared = tiny.run(tiny_root, name, seed=2 ** 31 + 7,
                                trace=trace)
    assert result["correct"] is True
    assert result["attempted"] >= 1
    # the same plain code paths on the CPU: every number is exactly 0
    assert all(v == 0 for v, _ in compared.values()), compared
    metrics = set(result["metrics"])
    cell = harness.find_cell(tiny_root, name)
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert metrics <= want
    if not trace:
        assert metrics == want
