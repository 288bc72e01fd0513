#!/usr/bin/env python3
"""Time the port's kernels (the cloth solves, the segment sum, the KL bisection) of this checkout, or of it and another in turns.

    python3 kernel_bench.py                  # this checkout, one run
    python3 kernel_bench.py --against DIR    # DIR, this, this, DIR: one process each
    python3 kernel_bench.py --nvcc-flags="--use_fast_math"   # built with extra nvcc flags
    python3 kernel_bench.py --rows                           # the segment sum's time against the rows of a CTA
    python3 kernel_bench.py --kl                             # the KL bisection alone (this checkout)

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
For the segment sum (`segment_sum_cuda`, `csrc/segment_sum.cu`): the largest
call of each HEPi family's update and collect (the edge set with the most
rows, the direction with the fewest segments), rebuilt from seed 0 the way
tests/test_torch_cuda.py builds them (the config's policy graph at its
minibatch size and at its envs; values `randn` of HEPi's width, 16
orientations x 64 channels, seed 1, in the config's dtype): cloth at 200 and
100 envs, rigid at 1000, rope at 200. Per call: bit-equality with the plain
version, the route taken (where the tree counts routes), device ms (as above)
and with the 50 MB L2 flushed before each launch, eager and host ms per call,
the plain version's and `index_add_`'s ms per call (CUDA events over 3 and
10 calls, as chip_smoke.py's phase 15b times them), and the bound (values,
perm and offsets read once, the output written once, over 3.35 TB/s) with
the share of it.
For the KL bisection (`rl/projections/kl.py` `_solve_eta_cuda`,
`csrc/kl_bisection.cu`; skipped in a tree without it): chip_smoke.py's phase
3b (`kl_call_stats`) on the update's calls [rows, K] of the rigid (1000 x 6;
1000 x 3 for rigid pushing), cloth (200 x 12) and rope (200 x 6)
configurations: rows whose eta differs from the plain loop's, device ms per
launch (as above), eager and host ms per call, the plain loop's ms and host
ms per call, one row's device ms, and the bound: the larger of the bytes
(var and old_var read, eps and eta) over 3.35 TB/s and the latency floor, 60
rounds of a round's dependent chain summed from each operation's latency on
one thread, timed apart from the kernel (`op_latency_ns`); with the share of
it. --kl also gives the library's load seconds (its nvcc build on a fresh
checkout).
--rows (this checkout only): the segment sum's vec16 route on values
[100, E, 1024] bf16 of one shared random CSR (seed 0), device ms per launch
against E = 0 .. 360 rows an env into 10 segments, with every env in one CTA
per tile (groups = 1) and with the plan's segment groups; and against N = 1 ..
90 segments of E = 90 rows (groups = 1). The slopes of the single-CTA lines
are the serial cost of a row and of a segment's store in one CTA.
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
# each HEPi family's config: its update's calls at the minibatch size, its collect's at the config's envs
SEGMENT_CONFIGS = (("cloth", "cloth_hanging_multi_hepi_trpl"), ("rigid", "rigid_insertion_multi_hepi_trpl"),
                   ("rope", "rope_closing_hepi_trpl"))


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def segment_calls():
    """[(family, kinds, values, csr)]: the largest segment sum of each HEPi
    family's update and collect, rebuilt from seed with the tree on sys.path."""
    import torch

    from geometry_rl_torch.config import DTYPES, _merge, load_config, trainer_from_config
    from geometry_rl_torch.rl.obs_pipeline import obs_norm_apply

    calls = []
    for family, config in SEGMENT_CONFIGS:
        cfg = load_config(config)
        sizes = {}  # B -> the steps whose largest call it is
        for kind, B in (("update", cfg["algorithm"]["objective"]["mini_batch_size"]), ("collect", cfg["env"]["num_envs"])):
            sizes.setdefault(B, []).append(kind)
        for B, kinds in sizes.items():
            trainer = trainer_from_config(_merge(cfg, {"env": {"num_envs": B, "kwargs": {"warmup_steps": 0}}}), device="cuda")
            env_state = trainer.env.reset(torch.Generator(device="cuda").manual_seed(0))
            state = trainer.init(torch.Generator(device="cuda").manual_seed(0))
            graph, _ = trainer.policy_builder.build(obs_norm_apply(state.norm, trainer.env.observe(env_state)))
            es = max(graph.edges.values(), key=lambda e: e.num_edges)
            csr = min((es.dst_csr, es.src_csr), key=lambda c: c.num_segments)
            width = cfg["algorithm"]["num_ori"] * cfg["algorithm"]["latent_dim"]
            dtype = DTYPES[cfg["algorithm"].get("dtype", "float32")]
            values = torch.randn((B, es.num_edges, width), generator=torch.Generator(device="cuda").manual_seed(1),
                                 device="cuda").to(dtype)
            calls.append((family, kinds, values, csr))
            del trainer, state, env_state, graph
    return calls


def segment_rows(label: str) -> list:
    """Time the tree's segment-sum kernel on `segment_calls()`."""
    import torch

    from chip_smoke import bound_ms, flushed_graph_ms, graph_ms, index_add_operands, launched_route, timed_ms
    from geometry_rl_torch.models import segment

    rows = []
    for family, kinds, values, csr in segment_calls():
        got, route = launched_route(values, csr)
        torch.cuda.synchronize()
        equal = torch.equal(got, segment.segment_sum_ref(values, csr))
        device = graph_ms(lambda: segment.segment_sum_cuda(values, csr))
        flushed = flushed_graph_ms(lambda: segment.segment_sum_cuda(values, csr))
        eager, host = timed_ms(lambda: segment.segment_sum_cuda(values, csr), 200)
        plain = timed_ms(lambda: segment.segment_sum_ref(values, csr), 3)[0]
        acc, flat, f32_rows = index_add_operands(values, csr)
        library = timed_ms(lambda: acc.index_add_(0, flat, f32_rows), 10)[0]
        del acc, flat, f32_rows
        B, E, F = values.shape
        elt = values.element_size()
        nbytes = values.numel() * elt + 4 * csr.perm.numel() + 4 * csr.offsets.numel() + B * csr.num_segments * F * elt
        bound, bound_by = bound_ms(nbytes, values.numel())
        depth = (csr.offsets[:, 1:] - csr.offsets[:, :-1]).max().item()
        rows.append({"kernel": "segment_sum", "family": family, "steps": kinds, "shape": [B, E, F],
                     "dtype": str(values.dtype), "segments": csr.num_segments, "per_env_csr": csr.perm.shape[0] > 1,
                     "longest_segment": depth, "route": route, "bit_equal": equal,
                     "device_ms": device, "flushed_ms": flushed, "eager_ms": eager, "host_ms": host,
                     "plain_ms": plain, "index_add_ms": library,
                     "bound_ms": bound, "bound_by": bound_by, "share_of_bound": bound / device,
                     "share_of_bound_flushed": bound / flushed})
        print(f"[bench] {label} segment_sum {family} {'+'.join(kinds)} [{B}, {E}, {F}] {values.dtype}, "
              f"{csr.num_segments} segments, longest {depth}, route {rows[-1]['route']}: bit-equal {equal}, device "
              f"{device:.5f} ms ({flushed:.5f} ms with the L2 flushed), eager {eager:.5f} ms per call, host "
              f"{host:.5f} ms per call; plain {plain:.4f} ms, index_add_ (f32 rows) {library:.5f} ms per call; "
              f"bound {bound:.5f} ms by {bound_by}, {100 * bound / device:.1f}% of it "
              f"({100 * bound / flushed:.1f}% flushed)", flush=True)
    return rows


def kl_rows(label: str) -> list:
    """Time the tree's KL bisection kernel on chip_smoke's `KL_CALLS` (none where the tree has no kernel)."""
    from chip_smoke import KL_CALLS, kl_call_stats, op_latency_ns  # this checkout's, for both trees
    from geometry_rl_torch.rl.projections import kl

    if not hasattr(kl, "_solve_eta_cuda"):
        return []
    latency = op_latency_ns()
    print(f"[bench] {label} one thread's dependent chain, ns an operation: "
          + ", ".join(f"{k} {v:.2f}" for k, v in latency.items()), flush=True)
    rows = []
    for i, (family, n, K) in enumerate(KL_CALLS):
        s = kl_call_stats(n, K, 1900 + 2 * i, latency)
        rows.append({"kernel": "kl_bisection", "family": family, "latency_ns": latency, **s})
        print(f"[bench] {label} kl_bisection {family} [{n}, {K}]: rows differing from the plain loop "
              f"{s['differing_rows']}, device {1e3 * s['ms']:.3f} us, eager {1e3 * s['eager_ms']:.3f} us per call, "
              f"host {1e3 * s['host_ms']:.3f} us per call; plain {s['plain_ms']:.4f} ms (host {s['plain_host_ms']:.4f} "
              f"ms) per call; one row {1e3 * s['one_row_ms']:.3f} us; latency floor "
              f"{1e3 * s['latency_floor_ms']:.3f} us, bytes {s['bytes']}; bound {1e3 * s['bound_ms']:.3f} us by "
              f"{s['bound_by']}, {100 * s['share_of_bound']:.1f}% of it", flush=True)
    return rows


def rows_sweep() -> dict:
    """The vec16 route's device ms against the rows and segments of a CTA (see --rows)."""
    import torch

    from chip_smoke import graph_ms
    from geometry_rl_torch.graphs.types import csr_from_index
    from geometry_rl_torch.models import segment

    g = torch.Generator(device="cuda").manual_seed(0)
    B, F = 100, 1024

    def timed(E, N, groups):
        csr = csr_from_index(torch.randint(0, N, (1, E), generator=g, device="cuda"), N)
        values = torch.randn((B, E, F), generator=g, device="cuda").to(torch.bfloat16)
        plan = segment.launch_plan(B, E, N, F, values.dtype, True)
        if groups is not None:
            plan = plan._replace(groups=groups, grid=plan.grid // plan.groups * groups)

        def call():
            return segment.segment_sum_cuda(values, csr, plan)

        out = call()
        torch.cuda.synchronize()
        if not torch.equal(out, segment.segment_sum_ref(values, csr)):
            raise RuntimeError(f"segment_sum disagrees with its plain version at E={E}, N={N}")
        return {"E": E, "N": N, "groups": plan.groups, "tile": plan.tile, "grid": plan.grid, "device_ms": graph_ms(call)}

    rows = [timed(E, 10, groups) for groups in (1, None) for E in (0, 45, 90, 180, 360)]
    rows += [timed(90, N, 1) for N in (1, 10, 45, 90)]

    def slope(points):  # least squares, ms per unit of x
        n = len(points)
        mx, my = sum(x for x, _ in points) / n, sum(y for _, y in points) / n
        return sum((x - mx) * (y - my) for x, y in points) / sum((x - mx) ** 2 for x, _ in points)

    per_row = slope([(r["E"], r["device_ms"]) for r in rows[:5]])
    per_segment = slope([(r["N"], r["device_ms"]) for r in rows[10:]])
    for r in rows:
        print(f"[bench] rows: E={r['E']} N={r['N']} groups={r['groups']} tile={r['tile']} grid={r['grid']}: "
              f"{r['device_ms']:.5f} ms", flush=True)
    print(f"[bench] rows: one CTA per env and tile: {1e3 * per_row:.4f} us a row, {1e3 * per_segment:.4f} us a "
          f"segment", flush=True)
    return {"rows": rows, "us_per_row_one_cta": 1e3 * per_row, "us_per_segment_one_cta": 1e3 * per_segment,
            "card": card()}


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
    label = f"{os.path.relpath(tree, HERE) or '.'} {nvcc_flags}"
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
            print(f"[bench] {label} {name} B={B} "
                  f"self_collision={self_collision}: max|kernel - plain| {err:.3e}, device {device:.5f} ms, "
                  f"eager {eager:.5f} ms per call, host {host:.5f} ms per call", flush=True)
    rows += segment_rows(label)
    rows += kl_rows(label)
    libraries = [name for name, _ in KERNELS] + ["segment_sum", "kl_bisection"]
    ptxas = {name: getattr(cuda_build, "BUILD_INFO", {}).get(name) for name in libraries}  # older trees: none
    print(f"[bench] ptxas: {ptxas}", flush=True)
    return {"tree": os.path.abspath(tree), "nvcc_flags": nvcc_flags, "card": card(), "ptxas": ptxas, "rows": rows}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", default=HERE, help="checkout whose kernels to time (default: this one)")
    parser.add_argument("--against", default=None, help="another checkout, timed in turns with this one")
    parser.add_argument("--nvcc-flags", default="", help="flags added to the kernels' nvcc build, space-separated")
    parser.add_argument("--rows", action="store_true", help="the segment sum's time against a CTA's rows and segments")
    parser.add_argument("--kl", action="store_true", help="the KL bisection alone, this checkout")
    opts = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_bench: torch.cuda.is_available() is False; this runs on a CUDA card only", file=sys.stderr)
        return 1
    if opts.rows:
        sys.path.insert(0, HERE)
        result = rows_sweep()
        print(result["card"])
        print(json.dumps(result))
        return 0
    if opts.kl:
        sys.path.insert(0, HERE)
        from geometry_rl_torch import cuda_build
        from geometry_rl_torch.utils.trace import counting, recording

        with recording() as rec, counting("setup.nvcc_builds") as built:
            cuda_build.load_library("kl_bisection")
        build_s = rec.totals()["setup.kernel_load.kl_bisection"][1]
        print(f"[bench] kl_bisection: {build_s:.2f} s loading, nvcc ran {built['setup.nvcc_builds']} times", flush=True)
        result = {"card": card(), "build_s": build_s, "nvcc_builds": built["setup.nvcc_builds"], "rows": kl_rows("."),
                  "ptxas": {"kl_bisection": cuda_build.BUILD_INFO.get("kl_bisection")}}
        print(result["card"])
        print(json.dumps(result))
        return 0
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
