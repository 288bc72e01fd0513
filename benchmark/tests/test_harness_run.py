"""The run's shape: each loop driven on the CPU at a small size gives the
result's keys; `benchmark.run` refuses without a card and without the port;
JAX found in the process is named."""

import json
import os
import shutil
import subprocess
import sys
import types

import pytest

from benchmark import manifest
from benchmark.run import loaded_forbidden
from benchmark.tests.common import tiny_run

KEYS = ["correct", "attempted", "failed", "metrics", "device", "check"]


@pytest.mark.parametrize("cell", [w["name"] for w in manifest.load_manifest()["workloads"]])
def test_each_cell_runs_on_the_cpu_at_a_small_size(cell):
    r = tiny_run(cell)
    assert list(r) == KEYS  # `check` last, as in the printed line
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    names = {m["name"] for m in manifest.load_cell(cell).end_to_end}
    assert set(r["metrics"]) == names and all(v["value"] > 0 for v in r["metrics"].values())
    assert r["device"]["platform"] == "cpu"  # a CPU run never names a device metric's platform "gpu"
    assert all(n["value"] <= n["limit"] for n in r["check"].values())
    json.dumps(r)


def _run(cwd, *extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    cell = manifest.load_manifest()["workloads"][0]["name"]
    return subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", cell,
                           "--seed", "1", "--seconds", "1", *extra], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_run_exits_nonzero_without_a_card():
    out = _run(manifest.ROOT)
    assert out.returncode != 0
    assert not out.stdout.strip()
    assert "CUDA" in out.stderr


def test_run_exits_nonzero_with_only_the_benchmark(tmp_path):
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(manifest.HERE, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path, "--trace", "1")
    assert out.returncode != 0 and not out.stdout.strip()


def test_forbidden_modules_are_found_by_whole_top_level_names(monkeypatch):
    assert "geometry_rl_torch" not in loaded_forbidden()
    monkeypatch.setitem(sys.modules, "geometry_rl_torch_extra", types.ModuleType("geometry_rl_torch_extra"))
    monkeypatch.setitem(sys.modules, "jaxlib_like", types.ModuleType("jaxlib_like"))
    assert loaded_forbidden() == []  # names that only begin with a forbidden one are not it
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "geometry_rl_tpu.models", types.ModuleType("geometry_rl_tpu.models"))
    assert {"jax", "geometry_rl_tpu"} <= set(loaded_forbidden())


def test_a_run_loads_no_jax():
    code = ("import sys; sys.argv=['x']; import benchmark.run, benchmark.harness, benchmark.readings, benchmark.trace; "
            "import geometry_rl_torch.config, geometry_rl_torch.train.ppo; from benchmark.run import loaded_forbidden; "
            "print(loaded_forbidden())")
    out = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
