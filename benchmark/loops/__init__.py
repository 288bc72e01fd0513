"""The loops that drive a cell's work: the general generator of the
benchmark's traffic. A traffic mix's file (`mixes/<mix>.json`) names its loop
in `loop`; the loop `<name>` is the file `loops/<name>.py` beside the cell's
files, whose class `Loop` the harness builds with the port's trainer, its
state, the cell and the seed. A new loop is a new file there: nothing else
changes. (Loop files are loaded by path, so they import absolutely.)

A `Loop` has `control_steps` and `minibatch_steps` (per train iteration; 0
where it has none), and:
- `setup()`: warm every shape up (set-up's time);
- `window(seconds)`: the measured window, a `Window`;
- `finish()`: after the window, what the check still needs from the port;
  `capture` then holds everything the check reads;
- `end_to_end(window)`: the end-to-end metrics of its cells;
- `slice()`: the short slice a traced run profiles.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import statistics
from typing import Dict, List

import torch


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Window:
    seconds: float  # wall time, ending in a synchronize
    attempted: int  # iterations (train) or control steps (rollout)
    failed: int  # ... whose outputs were not finite
    env_steps: int  # env-steps (frames) completed
    step_ms: List[float] = dataclasses.field(default_factory=list)  # rollout: each control step's time
    collect_s: List[float] = dataclasses.field(default_factory=list)  # train: each iteration's collect ...
    update_s: List[float] = dataclasses.field(default_factory=list)  # ... and update, the trainer's own timings
    host_s: Dict[str, float] = dataclasses.field(default_factory=dict)  # rollout: host seconds in each timed call


def p90(values: List[float]) -> float:
    return statistics.quantiles(values, n=10, method="inclusive")[8]


def load(cell):
    """The class `Loop` of the cell's loop, `loops/<loop>.py` under its files."""
    path = cell.bench_dir / "loops" / f"{cell.loop}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_loop_{cell.loop.replace('.', '_')}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.Loop
