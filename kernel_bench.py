#!/usr/bin/env python3
"""Time the cloth-solve kernels of this checkout, or of it and another in turns.

    python3 kernel_bench.py                  # this checkout, one run
    python3 kernel_bench.py --against DIR    # DIR, this, this, DIR: one process each
    python3 kernel_bench.py --nvcc-flags="--use_fast_math"   # built with extra nvcc flags

DIR is another checkout of the repository (for example the parent commit,
unpacked with `git archive`); each process builds its checkout's kernels into
that checkout's `geometry_rl_torch/_build/`. --nvcc-flags appends flags to
the build (in both trees with --against); the build hash covers them, so such
a build never replaces the port's own. For each kernel
(`cloth_position_solve_cuda`, K2's port; `cloth_position_solve_env_cuda`,
K1's) at B = 100 and B = 1000 with self-collision off (the main paths'
shapes) and B = 4 with it on, on the operands of chip_smoke.py's phase 3:
  - max |kernel - plain version|;
  - device ms per launch: 50 launches captured in a CUDA graph, replayed 10
    times between two CUDA events, so the wrapper's host time is not counted;
  - eager ms per call: 200 calls of the wrapper between two CUDA events, the
    way a caller launches it (host-bound where the wrapper is slower than the
    kernel), and the host clock's ms per call over the same loop;
and ptxas's registers, shared memory and spill bytes per kernel.
Each run prints the card (nvidia-smi name and power limit) and one JSON line;
with --against, a last JSON line holds all four runs. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SHAPES = ((100, False), (1000, False), (4, True))
KERNELS = (("cloth_solve", "cloth_position_solve_cuda"), ("cloth_solve_env", "cloth_position_solve_env_cuda"))


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def run_one(tree: str, nvcc_flags: str) -> dict:
    """Time `tree`'s kernels in this process, built with `nvcc_flags` added."""
    import torch

    from chip_smoke import graph_ms, solve_inputs, timed_ms  # this checkout's, for both trees

    sys.path.insert(0, tree)
    from geometry_rl_torch import cuda_build
    from geometry_rl_torch.envs import make_env
    from geometry_rl_torch.sim import cloth_solve

    cuda_build.NVCC_FLAGS = cuda_build.NVCC_FLAGS + tuple(nvcc_flags.split())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    for B, self_collision in SHAPES:
        env = make_env("cloth_hanging", num_envs=B, warmup_steps=0, self_collision=self_collision, device="cuda")
        args = solve_inputs(env, torch.Generator(device="cuda").manual_seed(1))
        ref = cloth_solve.cloth_position_solve_ref(*args)
        for name, fn_name in KERNELS:
            solve = getattr(cloth_solve, fn_name)
            err = (solve(*args) - ref).abs().max().item()
            device = graph_ms(lambda: solve(*args))
            eager, host = timed_ms(lambda: solve(*args), 200)
            rows.append({"kernel": name, "B": B, "self_collision": self_collision, "max_abs_err": err,
                         "device_ms": device, "eager_ms": eager, "host_ms": host})
            print(f"[bench] {os.path.relpath(tree, HERE) or '.'} {nvcc_flags} {name} B={B} "
                  f"self_collision={self_collision}: max|kernel - plain| {err:.3e}, device {device:.5f} ms, "
                  f"eager {eager:.5f} ms per call, host {host:.5f} ms per call", flush=True)
    ptxas = {name: getattr(cuda_build, "BUILD_INFO", {}).get(name) for name, _ in KERNELS}  # older trees: none
    print(f"[bench] ptxas: {ptxas}", flush=True)
    return {"tree": os.path.abspath(tree), "nvcc_flags": nvcc_flags, "card": card(), "ptxas": ptxas, "rows": rows}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", default=HERE, help="checkout whose kernels to time (default: this one)")
    parser.add_argument("--against", default=None, help="another checkout, timed in turns with this one")
    parser.add_argument("--nvcc-flags", default="", help="flags added to the kernels' nvcc build, space-separated")
    opts = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_bench: torch.cuda.is_available() is False; this runs on a CUDA card only", file=sys.stderr)
        return 1
    if opts.against is None:
        result = run_one(os.path.abspath(opts.tree), opts.nvcc_flags)
        print(result["card"])
        print(json.dumps(result))
        return 0
    runs = []
    for tree in (opts.against, HERE, HERE, opts.against):
        proc = subprocess.run([sys.executable, os.path.join(HERE, "kernel_bench.py"), "--tree", os.path.abspath(tree),
                               f"--nvcc-flags={opts.nvcc_flags}"], capture_output=True, text=True, cwd=HERE)
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    print(json.dumps({"runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
