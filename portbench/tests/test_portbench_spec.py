"""BENCHMARK.json against the rules it must keep, and every name in it
finding its files."""

import json
import os

import pytest

from portbench.harness import spec

B = spec.load_benchmark()
CELLS = [w["name"] for w in B["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(B["paths"]) <= 16 and 1 <= len(B["configs"]) <= 24
    assert 1 <= len(B["workloads"]) <= 24 and 1 <= len(B["end_to_end"]) <= 16
    assert 1 <= len(B["per_layer"]) <= 128
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024


def test_command_stays_inside_paths():
    assert len(B["command"]) <= 32
    for word in B["command"]:
        assert not word.startswith("/") and ".." not in word
        if word.endswith(".py"):
            assert any(word.startswith(p + "/") for p in B["paths"])
    for p in B["paths"]:
        assert len(p) <= 200 and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(spec.ROOT, p))


def _names():
    out = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        out += [(section, item["name"]) for item in B[section]]
    out += [("traffic", w["traffic"]) for w in B["workloads"]]
    out += [("config", w["config"]) for w in B["workloads"]]
    out += [("reduced", r) for c in B["configs"] for r in c["reduced"]]
    return out


@pytest.mark.parametrize("section,name", _names())
def test_names_use_only_allowed_characters(section, name):
    assert spec.NAME_RE.match(name), (section, name)


def test_names_are_unique():
    for section in ("configs", "workloads"):
        names = [x["name"] for x in B[section]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in B["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("m", B["end_to_end"] + B["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(m):
    assert spec.UNIT_RE.match(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
    e2e = [x["name"] for x in B["end_to_end"]]
    if m in B["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    assert set(m.get("workloads", CELLS)) <= set(CELLS)
    mod = spec.module("metrics", m["name"])
    assert callable(mod.read)


@pytest.mark.parametrize("cell", B["workloads"], ids=lambda w: w["name"])
def test_cell_finds_its_files_and_reports_enough(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4) and 1 <= len(cell["why"]) <= 200
    config = spec.load_config(B, cell["config"])
    traffic = spec.load_traffic(cell["traffic"])
    limits = spec.load_limits(cell["name"])
    assert set(limits) == {"unanswered", "bad_rows", "recall_short",
                           "dist_gap"}
    assert limits["unanswered"] == 0 and limits["bad_rows"] == 0
    assert callable(spec.module("drivers", traffic["driver"]).run)
    assert callable(spec.module("corpora",
                                config["corpus"]["generator"]).make)
    assert callable(spec.module("work", config["score_work"]).count)
    e2e = [m["name"] for m in spec.cell_metrics(B, cell["name"],
                                                "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = spec.cell_metrics(B, cell["name"], "per_layer")
    assert per_layer and all(m["moves"] in e2e for m in per_layer)


@pytest.mark.parametrize("c", B["configs"], ids=lambda c: c["name"])
def test_config_entry(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["file"].startswith("portbench/") and len(c["reduced"]) <= 16
    for text in (c["source"], c["why"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    with open(os.path.join(spec.ROOT, c["file"])) as f:
        body = json.load(f)
    assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
    assert body["source"] == c["source"]
    assert any(w["config"] == c["name"] for w in B["workloads"])
    files = [x["file"] for x in B["configs"]]
    assert files.count(c["file"]) == 1


def test_layers_are_named_alike():
    layers = {m["layer"] for m in B["per_layer"]}
    assert layers == {"index build", "search entry", "partitioning", "plan",
                      "score kernels", "merge", "reorder", "device"}
