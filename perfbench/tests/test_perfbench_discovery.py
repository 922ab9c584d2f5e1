"""BENCHMARK.json against the files it names: every cell's configuration,
traffic, limits and driver, every metric's reader, found by name."""

import importlib
import json
import os
import re

import pytest

from perfbench import core

ROOT = core.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "perfbench/run.py"]
    assert bench["paths"] == ["perfbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(bench, kind):
    names = [e["name"] for e in bench[kind]]
    assert len(set(names)) == len(names)
    for e in bench[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")


def test_configs_found_by_name(bench):
    for c in bench["configs"]:
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        importlib.import_module("perfbench.drivers." + cfg["driver"]).DRIVER
        assert len(c["why"]) <= 200 and len(c["source"]) <= 200


def test_workloads_found_by_name(bench):
    configs = {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        assert w["config"] in configs and w["chips"] == 1
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        for part in (("traffic", w["traffic"] + ".json"), ("limits", w["name"] + ".json")):
            assert os.path.exists(os.path.join(ROOT, "perfbench", *part)), part
        wl, cfg = core.cell(bench, w["name"])
        assert wl is w and cfg["name"] == w["config"]
        assert len(w["why"]) <= 200


def test_an_unlisted_workload_is_refused(bench):
    for name in ("amcl_2d_store.relocalize", "no_such_config.track"):
        with pytest.raises(KeyError):
            core.cell(bench, name)


def test_a_workload_without_its_limits_is_refused(monkeypatch, tmp_path):
    monkeypatch.setattr(core, "HERE", str(tmp_path))
    with pytest.raises(FileNotFoundError):
        core.run_cell("amcl_2d_store.track", 1, 1.0, False, device="cpu")


def test_every_metric_has_a_reader(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert {"setup_s", "scan_ms_p95", "scans_per_s"} <= e2e
    for m in bench["end_to_end"]:
        mod = importlib.import_module("perfbench.e2e." + m["name"])
        assert mod.UNIT == m["unit"] and callable(mod.read)
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        mod = importlib.import_module("perfbench.metrics." + m["name"])
        assert (mod.UNIT, mod.LAYER, mod.SOURCE, mod.MOVES) == (
            m["unit"], m["layer"], m["source"], m["moves"])
        assert m["moves"] in e2e and callable(mod.read)
        assert set(m.get("workloads", [])) <= {w["name"] for w in bench["workloads"]}


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        e2e = [m for m in bench["end_to_end"] if core.applies(m, w["name"])]
        per = [m for m in bench["per_layer"] if core.applies(m, w["name"])]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and per


def test_limits_name_every_compared_number(bench):
    for w in bench["workloads"]:
        with open(os.path.join(ROOT, "perfbench", "limits", w["name"] + ".json")) as f:
            assert set(json.load(f)) == set(core.check_names())
