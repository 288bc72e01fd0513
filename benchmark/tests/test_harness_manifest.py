"""BENCHMARK.json and the files it names: the contract's shapes, and a new
cell, mix, configuration or metric found by its files alone."""

import json
import re
import shutil

import pytest

from benchmark import loops, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\n\t]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}

M = manifest.load_manifest()


def test_top_level_keys_and_sizes():
    assert set(M) == TOP_KEYS
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    assert 1 <= len(M["paths"]) <= 16 and all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) for p in M["paths"])
    assert 1 <= len(M["command"]) <= 32 and all(TEXT.match(w) for w in M["command"])
    assert len(json.dumps(M).encode()) <= 64 * 1024
    runs = 2 + 14 * 24  # the check's runs with the full 24 cells
    assert runs * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", M["configs"], ids=lambda e: e["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and TEXT.match(entry["source"]) and TEXT.match(entry["why"])
    assert entry["file"].startswith("benchmark/") and manifest.ROOT.joinpath(entry["file"]).is_file()
    assert len(entry["reduced"]) <= 16 and all(NAME.match(k) for k in entry["reduced"])
    cfg = json.loads(manifest.ROOT.joinpath(entry["file"]).read_text())
    assert sorted(cfg["reduced"]) == sorted(entry["reduced"])  # the file lists every cut with its published value
    for key, cut in cfg["reduced"].items():
        assert set(cut["published"]) == set(cut["run"]) and all(cfg[key][k] == v for k, v in cut["run"].items())
    assert not any(k.endswith(("_dim", "_rank")) or "width" in k for k in entry["reduced"])


@pytest.mark.parametrize("entry", M["workloads"], ids=lambda e: e["name"])
def test_workload_entry(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(entry["name"]) and NAME.match(entry["traffic"]) and TEXT.match(entry["why"])
    assert entry["chips"] == 1
    assert entry["config"] in {c["name"] for c in M["configs"]}
    cell = manifest.load_cell(entry["name"])
    assert cell.spec["why"] == entry["why"]
    assert manifest.HERE.joinpath("loops", f"{cell.loop}.py").is_file()


@pytest.mark.parametrize("entry", M["end_to_end"] + M["per_layer"], ids=lambda e: e["name"])
def test_metric_entry(entry):
    e2e = entry in M["end_to_end"]
    keys = {"name", "unit", "better", "bound", "source"} if e2e else {"name", "unit", "better", "source", "layer", "moves"}
    assert set(entry) - {"workloads"} == keys
    assert NAME.match(entry["name"]) and UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    assert entry["source"] in (({"host_clock", "device_trace"}) if e2e else SOURCES)
    if e2e:
        assert 0 < entry["bound"] <= 0.25
    else:
        assert TEXT.match(entry["layer"])
        assert manifest.HERE.joinpath("metrics", f"{entry['name']}.py").is_file()
    if entry["name"].endswith("_roofline") or "_roofline." in entry["name"]:
        assert entry["unit"] == "%"


def test_names_are_unique():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in M[group]]
        assert len(names) == len(set(names)), group
    assert len({(w["config"], w["traffic"]) for w in M["workloads"]}) == len(M["workloads"])


def test_every_config_has_a_cell():
    assert {c["name"] for c in M["configs"]} == {w["config"] for w in M["workloads"]}


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in M["workloads"]:
        cell = manifest.load_cell(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer


def test_moves_is_reported_by_every_cell_of_the_metric():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    for m in M["per_layer"]:
        assert m["moves"] in e2e
        cells = e2e[m["moves"]].get("workloads", [w["name"] for w in M["workloads"]])
        assert set(m["workloads"]) <= set(cells), m["name"]


def test_layers_are_named_alike():
    layers = {m["layer"] for m in M["per_layer"]}
    assert all(len(layer.split()) <= 8 for layer in layers)


def test_a_new_cell_mix_loop_config_and_metric_are_found_by_their_files(tmp_path):
    """Copy the benchmark, add a configuration, a mix, a loop, a cell and a
    metric as new files (and their entries in BENCHMARK.json): each is found
    and read with no edit of any file that was there."""
    shutil.copytree(manifest.HERE, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    doc = json.loads(manifest.ROOT.joinpath("BENCHMARK.json").read_text())
    cfg = json.loads((tmp_path / "benchmark/configs/cloth_hanging_hepi_trpl.json").read_text())
    cfg["env"]["num_envs"] = 50
    (tmp_path / "benchmark/configs/cloth_small.json").write_text(json.dumps(cfg))
    (tmp_path / "benchmark/mixes/rollout_long_warmup.json").write_text(
        json.dumps({"loop": "rollout_marked", "warmup_steps": 9, "fold": 13}))
    (tmp_path / "benchmark/loops/rollout_marked.py").write_text(
        "from benchmark.loops.rollout import Loop as Rollout\n\n\nclass Loop(Rollout):\n    marker = 'new'\n")
    (tmp_path / "benchmark/workloads/cloth_small.rollout_long_warmup.json").write_text(json.dumps(
        {"config": "cloth_small", "mix": "rollout_long_warmup", "slice": {"control_steps": 2},
         "check": {"env_steps": 1, "horizon": 4, "limits": {"policy": 0.1, "env": 0.1}}, "why": "a test cell"}))
    (tmp_path / "benchmark/metrics/attempted_steps.rollout.py").write_text(
        "def read(ctx):\n    return float(ctx.window.attempted) if ctx.loop == 'rollout' else None\n")
    doc["configs"].append({"name": "cloth_small", "source": "a test", "file": "benchmark/configs/cloth_small.json",
                           "reduced": ["env"], "why": "a test configuration"})
    doc["workloads"].append({"name": "cloth_small.rollout_long_warmup", "config": "cloth_small",
                             "traffic": "rollout_long_warmup", "chips": 1, "why": "a test cell"})
    doc["per_layer"].append({"name": "attempted_steps.rollout", "unit": "steps", "better": "higher",
                             "source": "host_clock", "layer": "a test", "moves": "rollout_env_steps_per_s",
                             "workloads": ["cloth_small.rollout_long_warmup"]})
    doc["end_to_end"] = [dict(m, workloads=m["workloads"] + ["cloth_small.rollout_long_warmup"])
                         if m["name"].startswith("rollout_") else m for m in doc["end_to_end"]]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))

    cell = manifest.load_cell("cloth_small.rollout_long_warmup", root=tmp_path)
    assert cell.config["env"]["num_envs"] == 50 and cell.mix["warmup_steps"] == 9 and cell.loop == "rollout_marked"
    assert loops.load(cell).marker == "new"
    assert {m["name"] for m in cell.end_to_end} == {"rollout_env_steps_per_s", "rollout_step_ms_p90", "setup_s"}
    assert [m["name"] for m in cell.per_layer] == ["attempted_steps.rollout"]

    class Ctx:
        loop = "rollout"

        class window:
            attempted = 12

    assert manifest.read_per_layer(cell, Ctx()) == {"attempted_steps.rollout": {"value": 12.0, "unit": "steps"}}
    for name in (w["name"] for w in M["workloads"]):  # the old cells are as they were
        old = manifest.load_cell(name, root=tmp_path)
        assert [m["name"] for m in old.per_layer] == [m["name"] for m in manifest.load_cell(name).per_layer]


def test_bounds_are_at_least_one_percent():
    assert all(m["bound"] >= 0.01 for m in M["end_to_end"])
