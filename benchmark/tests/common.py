"""Small sizes at which a cell runs on the CPU in the tests."""

import dataclasses
import json
import time
from pathlib import Path

from benchmark import manifest
from benchmark.harness import run_cell

# each configuration cut to a test's size (widths too: the CPU runs them), in
# tiny/<config>.json: a new configuration brings its own file
TINY_DIR = Path(__file__).resolve().parent / "tiny"
TINY_CONFIGS = sorted(p.stem for p in TINY_DIR.glob("*.json"))
SEED = 2**31 + 4321  # above 32 signed bits: a run takes seeds of any size


def tiny_config(name: str):
    with open(manifest.HERE / "configs" / f"{name}.json") as f:
        cfg = json.load(f)
    with open(TINY_DIR / f"{name}.json") as f:
        tiny = json.load(f)
    for group, values in tiny.items():
        for k, v in values.items():
            if isinstance(v, dict):
                cfg[group][k].update(v)
            else:
                cfg[group][k] = v
    return cfg


def tiny_run(cell_name: str, seconds=1.0, **kwargs):
    cell = manifest.load_cell(cell_name)
    cell = dataclasses.replace(cell, config=tiny_config(cell.config_name))
    return run_cell(cell, SEED, seconds, False, "cpu", time.perf_counter(), **kwargs)
