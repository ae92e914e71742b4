"""BENCHMARK.json against the contract it is written to, and against the
files it names."""

import json
import os
import re

import pytest

from benchmark import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.manifest()


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert BENCH["paths"] == ["benchmark"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536


def test_names_units_and_text():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group in ("end_to_end", "per_layer"), e["name"]))
            for k in ("why", "layer", "source"):
                if k in e and group != "end_to_end" and group != "per_layer":
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] \
                        and "\t" not in e[k]
    metric_names = [n for m, n in names if m]
    assert len(metric_names) == len(set(metric_names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_cell_reports_what_its_metrics_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for w in BENCH["workloads"]:
        mine, layer = harness.cell_metrics(BENCH, w["name"])
        names = {m["name"] for m in mine}
        assert "setup_s" in names and len(names) >= 2
        assert layer, w["name"]
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):
            reports = e2e[m["moves"]].get("workloads", [cell])
            assert cell in reports, (m["name"], cell)


def test_every_config_has_a_cell_and_files_agree():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(BENCH["workloads"])
    for c in BENCH["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        assert c["source"] in conf["source"]
    for w in BENCH["workloads"]:
        wl, conf = harness.cell_files(w["name"])
        assert wl["config"] == w["config"] and wl["traffic"] == w["traffic"]
        assert wl["chips"] == w["chips"] and wl["why"] == w["why"]
        assert wl["limits"], w["name"]
        assert os.path.isfile(os.path.join(
            harness.HERE, "drivers", wl["driver"] + ".py"))
    for m in BENCH["per_layer"]:
        assert os.path.isfile(os.path.join(harness.HERE, "metrics",
                                           m["name"] + ".py"))


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_file_names_use_name_characters(name):
    for sub in ("workloads",):
        assert os.path.isfile(os.path.join(harness.HERE, sub, name + ".json"))
    for dirpath, _, files in os.walk(harness.HERE):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_layers_are_named_as_perf_md_lists_them():
    with open(os.path.join(ROOT, "PERF.md")) as f:
        perf = f.read()
    layers = perf[perf.index("## 3. Layers"):perf.index("## 4. Cells")]
    for m in BENCH["per_layer"]:
        assert f"\n| {m['layer']} |" in layers, m["layer"]
