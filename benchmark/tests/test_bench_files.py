"""Every configuration, mix and metric loads by name, BENCHMARK.json keeps
the contract's shape, and a new file is found without editing another."""

import json
import re
import shutil

import pytest

from benchmark import harness

SPEC = harness.spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51


def test_entries_keep_their_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}


def test_names_units_and_lines():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    named = SPEC["configs"] + SPEC["workloads"] + metrics
    for entry in named:
        assert NAME.match(entry["name"]), entry["name"]
    for group in (SPEC["configs"], SPEC["workloads"], metrics):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in {"lower", "higher"}
        assert m["source"] in SOURCES
    for text in ([e["why"] for e in SPEC["configs"] + SPEC["workloads"]]
                 + [c["source"] for c in SPEC["configs"]]
                 + [m["layer"] for m in SPEC["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_config_file_matches_its_entry(entry):
    cfg = harness.config(entry["name"])
    assert entry["file"] == f"benchmark/configs/{entry['name']}.json"
    assert cfg["name"] == entry["name"]
    assert cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    assert cfg["precision"] == "float32"
    assert any(w["config"] == entry["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("entry", SPEC["workloads"], ids=lambda e: e["name"])
def test_cell_loads_by_name(entry):
    c = harness.cell(SPEC, entry["name"])
    assert c["traffic"]["name"] == entry["traffic"]
    assert "setup_s" in c["end_to_end"] and len(c["end_to_end"]) >= 2
    assert c["per_layer"]
    for name in c["end_to_end"] + c["per_layer"]:
        assert callable(harness.metric(name).read)


@pytest.mark.parametrize("m", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_file_declares_its_entry(m):
    mod = harness.metric(m["name"])
    assert mod.UNIT == m["unit"] and mod.SOURCE == m["source"]
    assert mod.LAYER == m.get("layer") and mod.MOVES == m.get("moves")
    assert mod.read({}) is None     # nothing to read: nothing returned


def test_metrics_of_one_layer_name_it_alike():
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def _copy(tmp_path, monkeypatch):
    """A copy of the benchmark's data beside a copy of BENCHMARK.json,
    with the harness pointed at it."""
    here = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(harness.HERE / sub, here / sub)
    spec = json.loads(json.dumps(SPEC))
    monkeypatch.setattr(harness, "HERE", here)
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    return here, spec


def test_new_traffic_and_metric_are_found_by_name(tmp_path, monkeypatch):
    here, spec = _copy(tmp_path, monkeypatch)
    mix = dict(harness.traffic("split-all"), name="split-half-second",
               trace_seconds=0.5)
    (here / "traffic" / "split-half-second.json").write_text(json.dumps(mix))
    (here / "metrics" / "frames_traced.py").write_text(
        'LAYER = "orchestrator and engines"\nUNIT = "frames"\n'
        'SOURCE = "program_counter"\nMOVES = "frame_ms"\n\n\n'
        'def read(rec):\n    t = rec.get("trace")\n'
        '    return t["frames"] if t else None\n')
    spec["workloads"].append({"name": "ap1m-split-half", "config":
                              "ap-1m-1024", "traffic": "split-half-second",
                              "chips": 1, "why": "a test cell"})
    spec["per_layer"].append({"name": "frames_traced", "unit": "frames",
                              "better": "higher", "source":
                              "program_counter", "layer":
                              "orchestrator and engines",
                              "moves": "frame_ms"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    c = harness.cell(harness.spec(), "ap1m-split-half")
    assert c["traffic"]["trace_seconds"] == 0.5
    assert c["config"]["num_particles"] == 1_048_576
    # a metric naming no cells goes to every cell reporting what it moves
    assert "frames_traced" in c["per_layer"]
    assert "frames_traced" in harness.cell(harness.spec(),
                                           "ap1m-split")["per_layer"]
    assert harness.metric("frames_traced").read({"trace": {"frames": 7}}) == 7


def test_new_config_is_found_by_name(tmp_path, monkeypatch):
    here, spec = _copy(tmp_path, monkeypatch)
    cfg = dict(harness.config("ap-1m-1024"), name="ap-262k-720p",
               num_particles=262_144, width=1280, height=720)
    (here / "configs" / "ap-262k-720p.json").write_text(json.dumps(cfg))
    spec["workloads"].append({"name": "ap262k-split-720p", "config":
                              "ap-262k-720p", "traffic": "split-all",
                              "chips": 1, "why": "a test cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    c = harness.cell(harness.spec(), "ap262k-split-720p")
    assert (c["config"]["width"], c["config"]["height"]) == (1280, 720)
    assert c["end_to_end"] == ["frame_ms", "setup_s"]
