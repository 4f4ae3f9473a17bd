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
        reader = harness.load_module(cell.metric_file(m["name"]))
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
        for m in conf.get("models", []):
            assert {"model", "config", "precision"} <= set(m)


@pytest.mark.parametrize("name,trace", [
    ("tiny_rest.train", False), ("tiny_bldg.train", True),
    ("tiny_rest.frame", True), ("tiny_city.frame", False),
    ("tiny_kitti.frame", False)])
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


def test_a_deployment_of_three_generators_reads_as_files(tiny_root):
    """The KITTI-shaped cell: one configuration whose ``models`` add the
    BLDG and CAR generators, and a city that its traffic file's
    ``builder`` names, with cars in KITTI-360's car range."""
    from gcbench.kinds.frame import Plan

    cell = harness.find_cell(tiny_root, "tiny_kitti.frame")
    plan = Plan(cell, seed=3)
    assert list(plan.confs) == ["REST", "BLDG", "CAR"]
    assert plan.budgets == {k: 4096 for k in plan.confs}
    ins = plan.projections["REST"]["INS"]
    assert len({int(i) for i in ins[ins >= 10000]}) == 12
    assert plan.rcfgs["REST"].dataset.flip_ud


def test_a_generator_given_twice_is_refused(tmp_path):
    tiny.write_bench(str(tmp_path))
    path = os.path.join(str(tmp_path), "gcbench", "configs",
                        "tiny-kitti.json")
    conf = json.load(open(path))
    conf["models"].append(dict(conf["models"][0]))
    with open(path, "w") as f:
        json.dump(conf, f)
    with pytest.raises(SystemExit, match="BLDG"):
        harness.find_cell(str(tmp_path), "tiny_kitti.frame")
