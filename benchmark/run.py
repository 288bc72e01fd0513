"""Run one cell of the benchmark on the card and print its result.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Exits non-zero, printing no result, where
there is no CUDA card (or fewer than the cell asks for), where the port
cannot be imported, and where JAX, jaxlib, flax, optax or the JAX package
is loaded once the window has closed. Otherwise the last line of standard
output is one JSON object: `correct`, `attempted`, `failed`, `metrics`
(the cell's end-to-end metrics, or with `--trace 1` its per-layer ones),
`device`, with `--trace 1` `breakdown`, and last `check`: each number the
correctness check compared, with its limit. The numbers and limits are also
the last lines of standard error; the card's name and power limit an
earlier one.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

# the port's kernels build into geometry_rl_torch/_build/ inside the checkout;
# keep PyTorch's own caches there too, at fixed paths
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "geometry_rl_torch", "_build", "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "geometry_rl_torch", "_build", "triton"))

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "geometry_rl_tpu")


def loaded_forbidden():
    """Top-level names of loaded modules that are JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def finite(x):
    """`x` with every infinite or NaN number replaced by the largest float,
    so that the line is strict JSON."""
    if isinstance(x, float) and not math.isfinite(x):
        return sys.float_info.max
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite(v) for v in x]
    return x


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().replace("\n", "; ") or out.stderr.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from . import manifest

    cell = manifest.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"[benchmark] {cell.name} needs {cell.chips} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, {torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    print(f"[benchmark] card, power limit: {card_line()}", file=sys.stderr, flush=True)

    from .harness import run_cell

    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = loaded_forbidden()
    if found:
        print(f"[benchmark] JAX or the JAX package is loaded: {found}", file=sys.stderr)
        return 3
    for name, n in result["check"].items():
        print(f"[benchmark] check {name}: {n['value']!r} (limit {n['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(finite(result), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
