"""Small sizes at which a cell runs on the CPU in the tests."""

import dataclasses
import json
import time

from benchmark import manifest
from benchmark.harness import run_cell

# the cells' configurations cut to a test's size (widths too: the CPU runs them)
TINY = {
    "cloth_hanging_hepi_trpl": {"env": {"num_envs": 2, "kwargs": {"warmup_steps": 1, "episode_length": 3}},
                                "collector": {"frames_per_batch": 8},
                                "algorithm": {"latent_dim": 8, "num_ori": 4, "objective": {"mini_batch_size": 4}}},
    "rigid_insertion_hepi_trpl": {"env": {"num_envs": 8, "kwargs": {"warmup_steps": 0, "episode_length": 8}},
                                  "collector": {"frames_per_batch": 32},
                                  "algorithm": {"latent_dim": 8, "num_ori": 4, "objective": {"mini_batch_size": 16}}},
}
SEED = 2**31 + 4321  # above 32 signed bits: a run takes seeds of any size


def tiny_config(name: str):
    with open(manifest.HERE / "configs" / f"{name}.json") as f:
        cfg = json.load(f)
    for group, values in TINY[name].items():
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
