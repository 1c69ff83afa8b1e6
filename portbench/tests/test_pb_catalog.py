"""The benchmark is found by name: every workload file names a
configuration, a traffic file and readers that exist; names, units and
one-line texts keep to the characters BENCHMARK.json allows;
BENCHMARK.json, where the checkout has it, lists what the files hold."""

from __future__ import annotations

import json
import pathlib
import re

import pytest

from portbench import harness

HERE = pathlib.Path(harness.__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = sorted(p.stem for p in (HERE / "workloads").glob("*.json"))
METRICS = sorted(p.stem for p in (HERE / "metrics").glob("*.py"))
KINDS = sorted(p.stem for p in (HERE / "traffic").glob("*.py"))


def one_line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


@pytest.mark.parametrize("name", WORKLOADS)
def test_workload_resolves(name):
    cell = harness.load_json("workloads", name)
    assert cell["name"] == name and NAME.match(name)
    cfg = harness.load_json("configs", cell["config"])
    assert cfg["name"] == cell["config"] and NAME.match(cfg["name"])
    assert one_line(cfg["source"]) and isinstance(cfg["reduced"], list)
    traffic = harness.load_json("traffic", cell["traffic"])
    assert callable(harness.load_kind(traffic["kind"]).Traffic)
    assert traffic["measure"] in ("rate", "seconds_per_step")
    assert NAME.match(traffic["metric"]) and UNIT.match(traffic["unit"])
    assert cell["chips"] in (1, 4) and one_line(cell["why"])
    assert cell["control"] in ("fp8", "tf32")
    assert set(cell["per_layer"]) <= set(METRICS)
    for k, v in cell["limits"].items():
        assert NAME.match(k) and v is not None and v >= 0


@pytest.mark.parametrize("kind", KINDS)
def test_traffic_kind_resolves(kind):
    mod = harness.load_kind(kind)
    for attr in ("setup", "step", "release", "check"):
        assert callable(getattr(mod.Traffic, attr))


@pytest.mark.parametrize("name", METRICS)
def test_metric_reader_resolves(name):
    mod = harness.load_metric(name)
    assert NAME.match(name) and UNIT.match(mod.UNIT)
    assert callable(mod.read)


def test_benchmark_json_lists_the_files():
    path = ROOT / "BENCHMARK.json"
    if not path.exists():
        pytest.skip("no BENCHMARK.json in this checkout")
    b = json.loads(path.read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert {c["name"] for c in b["configs"]} <= {
        p.stem for p in (HERE / "configs").glob("*.json")}
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file()
    names = {m["name"] for m in b["end_to_end"] + b["per_layer"]}
    for w in b["workloads"]:
        cell = harness.load_json("workloads", w["name"])
        assert (w["config"], w["traffic"], w["chips"], w["why"]) == (
            cell["config"], cell["traffic"], cell["chips"], cell["why"])
        traffic = harness.load_json("traffic", cell["traffic"])
        assert traffic["metric"] in names
    for m in b["per_layer"]:
        assert m["name"] in METRICS
        assert UNIT.match(m["unit"]) and one_line(m["layer"])
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
