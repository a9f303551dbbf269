"""BENCHMARK.json against the benchmark's contract, and every name in it
backed by its files."""

import json
import os
import re

import pytest

from h100_bench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|expansion)|(_dim|_rank)$"
                   r"|experts_per_tok")


@pytest.fixture(scope="module")
def manifest():
    return harness.load_manifest()


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert 1 <= len(manifest["command"]) <= 32 and all(line(w) for w in manifest["command"])
    files = [w for w in manifest["command"] if w.endswith(".py")]
    assert files and all(any(f.startswith(p + "/") for p in manifest["paths"]) for f in files)
    assert isinstance(manifest["run_seconds"], int) and 1 <= manifest["run_seconds"] <= 51
    assert len(json.dumps(manifest)) <= 64 * 1024


def test_entries_names_and_units(manifest):
    for kind, keys in ENTRY_KEYS.items():
        names = [e["name"] for e in manifest[kind]]
        assert len(names) == len(set(names)), kind
        for e in manifest[kind]:
            assert set(e) <= keys, (kind, e["name"])
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e:
                    assert line(e[k]), (e["name"], k)
    assert 1 <= len(manifest["configs"]) <= 24 and 1 <= len(manifest["workloads"]) <= 24
    assert 1 <= len(manifest["end_to_end"]) <= 16 and 1 <= len(manifest["per_layer"]) <= 128


def test_configs(manifest):
    used = {w["config"] for w in manifest["workloads"]}
    files = [c["file"] for c in manifest["configs"]]
    assert len(files) == len(set(files))
    for c in manifest["configs"]:
        assert c["name"] in used
        assert c["source"].startswith("https://")
        assert any(c["file"].startswith(p + "/") for p in manifest["paths"])
        assert len(c["reduced"]) <= 16
        with open(os.path.join(harness.ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key), key
        assert "assumed" in cfg


def test_workloads(manifest):
    configs = {c["name"] for c in manifest["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = [w for w in manifest["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(manifest["workloads"]) // 4)
    for w in manifest["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"])
        mix_path = os.path.join(harness.BENCH, "mixes", w["traffic"] + ".json")
        with open(mix_path) as f:
            mix = json.load(f)
        assert os.path.exists(os.path.join(harness.BENCH, "drivers", mix["driver"] + ".py"))
        assert os.path.exists(os.path.join(harness.BENCH, "limits", w["name"] + ".json"))


def test_every_cell_reports_setup_another_end_to_end_and_a_layer(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in manifest["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in manifest["workloads"]:
        names = {m["name"] for m in harness.cell_metrics(manifest, w["name"], False)}
        assert "setup_s" in names and len(names) >= 2, w["name"]
        assert harness.cell_metrics(manifest, w["name"], True), w["name"]


def test_per_layer_moves_a_metric_every_listed_cell_reports(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    cells = {w["name"] for w in manifest["workloads"]}
    for m in manifest["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e, m["name"]
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", [cell]), (m["name"], cell)
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_metric_has_its_reader(manifest):
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert harness.metric_reader(m["name"]) is not None, m["name"]


def test_layers_are_named_alike(manifest):
    by_layer = {}
    for m in manifest["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_files_under_paths_are_named_from_name_characters(manifest):
    for p in manifest["paths"]:
        for dirpath, dirnames, filenames in os.walk(os.path.join(harness.ROOT, p)):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for f in filenames:
                rel = os.path.relpath(os.path.join(dirpath, f), harness.ROOT)
                assert PATH.match(rel), rel


def test_a_full_check_fits_with_24_cells(manifest):
    rs = manifest["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
