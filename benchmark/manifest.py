"""The benchmark's data, found by name.

`BENCHMARK.json` at the checkout's root lists the cells and metrics; a cell
`<name>` is `workloads/<name>.json`, which names its configuration
(`configs/<config>.json`) and its traffic mix (`mixes/<mix>.json`); a
per-layer metric `<name>` is read by `metrics/<name>.py`'s `read(ctx)`. A new
cell, mix, configuration or metric is a new file and a new entry in
`BENCHMARK.json`: nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config_name: str
    config: Dict  # the resolved configuration, as `geometry_rl_torch.config.trainer_from_config` takes it
    mix_name: str
    mix: Dict  # the traffic mix's parameters; `loop` names the loop that drives the window
    spec: Dict  # the cell's own file: slice sizes, the check's settings and limits
    end_to_end: List[Dict]  # BENCHMARK.json's end-to-end metrics this cell reports
    per_layer: List[Dict]  # ... and its per-layer metrics
    bench_dir: Path

    @property
    def loop(self) -> str:
        return self.mix["loop"]


def load_manifest(root: Path = ROOT) -> Dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of the manifest at `root`, with its files under
    `root/benchmark`. Raises KeyError for a cell the manifest lacks."""
    root = Path(root)
    bench_dir = root / "benchmark"
    manifest = load_manifest(root)
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in {root / 'BENCHMARK.json'}; cells: "
                       f"{[w['name'] for w in manifest['workloads']]}")
    spec = _read_json(bench_dir / "workloads" / f"{name}.json")
    if (spec["config"], spec["mix"]) != (entry["config"], entry["traffic"]):
        raise ValueError(f"{name}: the cell's file names {spec['config']} / {spec['mix']}, BENCHMARK.json "
                         f"{entry['config']} / {entry['traffic']}")
    end_to_end = [m for m in manifest["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in manifest["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(
        name=name, chips=int(entry["chips"]), config_name=entry["config"],
        config=_read_json(bench_dir / "configs" / f"{entry['config']}.json"), mix_name=entry["traffic"],
        mix=_read_json(bench_dir / "mixes" / f"{entry['traffic']}.json"), spec=spec, end_to_end=end_to_end,
        per_layer=per_layer, bench_dir=bench_dir,
    )


def reader(metric: str, bench_dir: Path = HERE) -> Callable:
    """`read(ctx) -> float | None` of `metrics/<metric>.py` (the file is
    loaded by path: metric names hold dots)."""
    path = Path(bench_dir) / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric.replace('.', '_')}", path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_per_layer(cell: Cell, ctx) -> Dict[str, Dict]:
    """Each of the cell's per-layer metrics that its reader finds, as
    {name: {"value", "unit"}}; a reader that finds nothing is left out."""
    out: Dict[str, Dict] = {}
    for m in cell.per_layer:
        value: Optional[float] = reader(m["name"], cell.bench_dir)(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
