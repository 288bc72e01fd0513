#!/usr/bin/env python3
"""The port's spans (`geometry_rl_torch/utils/trace.py`) measured in one
benchmark cell, around the harness's own pieces; and the host cost of a span.

    python3 span_bench.py --workload <cell> --seed <n> [--out FILE]
    python3 span_bench.py --cost                            # ns a span, recording off and on
    python3 span_bench.py --workload <cell> --seed 1 --tiny  # a rehearsal on the CPU at a tiny size

For a cell (on the card; the harness has no switch for the recorder):
  - set-up as the harness runs it, recorded: the wall time of imports, CUDA
    init, `trainer_from_config`, `init` and the loop's warm-up, beside the
    `setup.*` spans and the nvcc runs;
  - six windows, recording off, on, on, off, off, on (12 s of rollout, or
    two train iterations, a window): the benchmark's readings
    (`env_step_host_ms`, `policy_host_ms` by the rollout loop's `HostTimer`;
    `update_ms_per_minibatch`, `collect_ms_per_step` by the trainer's
    timings) and, when on, each span's calls and host and self ms per control
    or minibatch step in the same window, the twins of those readings;
  - on the card, the rigid env's physics is one CUDA graph replayed a control
    step (`geometry_rl_torch/sim/graph.py`): `envs.physics` wraps the replay,
    the counters `sim.physics_graph.captures` / `.replays` are printed for
    set-up and per step of each window, and the `sim.*` spans are recorded
    only in set-up's capture pass (printed apart), none in a window;
  - the benchmark's traced slice (`benchmark/trace.py`), recording off, then
    again with recording on: `reduce_events` of both; the kernels inside each
    span's and each range's device mirror, per step; and the slice's idle
    gaps named by the innermost of the benchmark's ranges alone, and of the
    ranges and the spans.
Each part prints one `[spans]` line of JSON; --out writes them all to FILE.

--cost times 200,000 spans (a `with span` and a `@spanned` call, the loop's
own time taken off) in the turns off, on, on, off, one thread.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

LAYERS = ("setup.", "train.", "rl.", "envs.", "sim.", "kernels.", "graphs.", "models.")
ROLLOUT_SPANS = ("envs.step", "envs.physics", "envs.action", "envs.reward", "envs.reset_draw", "envs.observe",
                 "sim.substep", "sim.joints", "sim.contacts", "sim.integrate", "sim.velocity", "train.policy",
                 "graphs.build", "models.forward", "kernels.segment_sum")
PHYSICS_GRAPH = ("sim.physics_graph.captures", "sim.physics_graph.replays")
TURNS = ("off", "on", "on", "off", "off", "on")  # recording off or on, a window each
ROLLOUT_SECONDS, TRAIN_ITERATIONS = 12.0, 2  # a window
TRAIN_SPANS = ("train.minibatch", "train.backward", "train.optimizer", "rl.projection", "rl.kl_bisection",
               "train.policy", "train.critic", "envs.step", "kernels.cloth_solve", "kernels.segment_sum")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def span_cost(n: int = 200_000) -> list:
    """ns a span, recording off and on, in the turns off, on, on, off."""
    import torch

    from geometry_rl_torch.utils.trace import recording, span, spanned

    torch.set_num_threads(1)

    @spanned("test.fn")
    def fn():
        return None

    def loop():
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with span("test.a"):
                pass
        t1 = time.perf_counter_ns()
        for _ in range(n):
            fn()
        t2 = time.perf_counter_ns()
        for _ in range(n):
            pass
        t3 = time.perf_counter_ns()
        return (t1 - t0 - (t3 - t2)) / n, (t2 - t1 - (t3 - t2)) / n

    rows = []
    for turn in ("off", "on", "on", "off"):
        if turn == "on":
            with recording() as rec:
                w, d = loop()
            assert len(rec.spans) == 2 * n
        else:
            w, d = loop()
        rows.append({"turn": turn, "with_span_ns": w, "spanned_call_ns": d})
        print(f"[spans] cost {turn}: with span {w:.0f} ns, @spanned call {d:.0f} ns (the loop's own time taken off)",
              flush=True)
    return rows


def tiny(cfg: dict) -> None:
    cfg["env"]["num_envs"] = 2
    cfg["env"]["kwargs"]["episode_length"] = 3
    cfg["collector"]["frames_per_batch"] = 8
    cfg["algorithm"].update(latent_dim=8, num_ori=4)
    cfg["algorithm"]["objective"].update(mini_batch_size=4, ppo_epochs=1)


def measure_cell(args) -> dict:
    from benchmark import loops, manifest

    cell = manifest.load_cell(args.workload)
    import torch

    torch.set_num_threads(1)
    card = "cpu" if args.tiny else card_line()
    from benchmark.harness import build_system
    from benchmark.loops import sync
    from benchmark.trace import RANGES, Calls, _innermost, _inside, _merge, range_patches, reduce_events, traced_slice
    from geometry_rl_torch.utils.trace import counting, recording

    t_imports = time.perf_counter() - T_START
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cpu" if args.tiny else "cuda"
    t0 = time.perf_counter()
    torch.zeros(1, device=dev)
    sync(dev)
    cuda_init = time.perf_counter() - t0
    cfg = copy.deepcopy(cell.config)
    if args.tiny:
        tiny(cfg)
    with recording() as srec, counting("setup.nvcc_builds", *PHYSICS_GRAPH) as built:
        t0 = time.perf_counter()
        trainer = build_system(cfg, dev, "port")
        t1 = time.perf_counter()
        state = trainer.init(torch.Generator(device=dev).manual_seed(args.seed))
        t2 = time.perf_counter()
        loop = loops.load(cell)(trainer, state, cell, args.seed)
        loop.setup()
        sync(dev)
        t3 = time.perf_counter()
    setup = {"setup_s": time.perf_counter() - T_START, "imports_s": t_imports, "cuda_init_s": cuda_init,
             "build_wall_s": t1 - t0, "init_wall_s": t2 - t1, "warmup_s": t3 - t2,
             "spans": {k: v for k, v in srec.totals().items() if k.startswith("setup.")},
             "nvcc_builds": built["setup.nvcc_builds"],
             "physics_graph": {k: built[k] for k in PHYSICS_GRAPH},
             "capture_pass_spans": {k: v for k, v in srec.totals().items() if k.startswith("sim.")}}
    print(f"[spans] {cell.name} on {card}: setup {json.dumps(setup)}", flush=True)
    if built["sim.physics_graph.captures"]:
        print(f"[spans] {cell.name}: the physics replays a CUDA graph; its sim.* spans (capture_pass_spans) come from "
              "set-up's capture pass, and a window records none: envs.physics wraps the replay", flush=True)

    rollout = cell.loop == "rollout"
    n_envs = trainer.env.cfg.num_envs
    gc.collect()
    gc.freeze()
    gc.disable()

    def rollout_window():
        from benchmark.capture import Patches
        from benchmark.loops.rollout import HostTimer

        tr = loop.trainer
        timer = HostTimer()
        n = 0
        with Patches([(tr.env, "step", timer.wrap(tr.env.step, "env.step")),
                      (tr, "_policy_dist", timer.wrap(tr._policy_dist, "policy"))]), counting(*PHYSICS_GRAPH) as graph:
            sync(tr.device)
            ns0, t0 = time.perf_counter_ns(), time.perf_counter()
            while time.perf_counter() - t0 < ROLLOUT_SECONDS:
                loop._next()
                n += 1
            sync(tr.device)
            wall, ns1 = time.perf_counter() - t0, time.perf_counter_ns()
        return {"steps": n, "wall_s": wall, "rate": n * n_envs / wall,
                "env_step_host_ms": 1e3 * timer.seconds["env.step"] / n,
                "policy_host_ms": 1e3 * timer.seconds["policy"] / n,
                "physics_graph_per_step": {k: v / n for k, v in graph.items()}}, (ns0, ns1), n

    def train_window():
        tr = loop.trainer
        col, upd = [], []
        sync(tr.device)
        ns0, t0 = time.perf_counter_ns(), time.perf_counter()
        for _ in range(TRAIN_ITERATIONS):
            loop.state, m = tr.train_iteration(loop.state)
            col.append(float(m["train/collect_time"]))
            upd.append(float(m["train/update_time"]))
        wall, ns1 = time.perf_counter() - t0, time.perf_counter_ns()
        n_mb = TRAIN_ITERATIONS * loop.minibatch_steps
        return {"iterations": TRAIN_ITERATIONS, "wall_s": wall,
                "rate": TRAIN_ITERATIONS * loop.control_steps * n_envs / wall,
                "update_ms_per_minibatch": 1e3 * statistics.mean(upd) / loop.minibatch_steps,
                "collect_ms_per_step": 1e3 * statistics.mean(col) / loop.control_steps}, (ns0, ns1), n_mb

    window = rollout_window if rollout else train_window
    turns = []
    for turn in TURNS:
        if turn == "on":
            with recording() as rec:
                w, (ns0, ns1), n = window()
            per = {k: {"calls_per_step": c / n, "host_ms_per_step": 1e3 * h / n, "self_ms_per_step": 1e3 * s / n}
                   for k, (c, h, s) in rec.totals(ns0, ns1).items()}
            w["spans_per_step"] = per
            w["spans_recorded"] = len(rec.spans)
        else:
            w, _, n = window()
        w["turn"] = turn
        turns.append(w)
        print(f"[spans] {cell.name} window {turn}: " + json.dumps({k: v for k, v in w.items() if k != "spans_per_step"}),
              flush=True)
        if turn == "on":
            print(f"[spans] {cell.name} spans per {'control' if rollout else 'minibatch'} step: "
                  + json.dumps({k: w["spans_per_step"].get(k) for k in (ROLLOUT_SPANS if rollout else TRAIN_SPANS)}),
                  flush=True)
    gc.enable()

    # the benchmark's own traced slice, recording off; then the same slice with recording on
    sl_off = traced_slice(loop)
    calls = {"segment_sum": Calls(), "cloth_solve": Calls()}
    acts = [torch.profiler.ProfilerActivity.CPU] + ([] if args.tiny else [torch.profiler.ProfilerActivity.CUDA])
    with recording() as rec, range_patches(loop.trainer, calls), torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        sizes = loop.slice()
        wall = time.perf_counter() - t0
    events = prof.events()
    sl_on = reduce_events(events, wall, sizes, calls)
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    prog = {e.name for e in events if e.device_type == cpu and e.name.startswith(LAYERS)}
    mirrors, host = defaultdict(list), defaultdict(list)
    kernels = []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            if e.name in RANGES or e.name in prog:
                mirrors[e.name].append((a, b))
            elif not getattr(e, "is_user_annotation", False) and not e.name.startswith("Optimizer."):
                kernels.append((a, b, e.name))
        elif e.device_type == cpu and (e.name in RANGES or e.name in prog):
            host[e.name].append((a, b))
    kernels.sort()
    per = sizes["control_steps"] if rollout else sizes["minibatch_steps"]
    inside = {}
    for name in sorted(set(RANGES) | prog):
        merged = _merge(mirrors[name])
        inner = [(a, b) for a, b, _ in kernels if _inside(merged, 0.5 * (a + b))]
        inside[name] = {"kernels_per_step": len(inner) / per, "device_ms_per_step": sum(b - a for a, b in inner) / 1e3 / per,
                        "mirrors": len(mirrors[name]), "host_calls": len(host[name])}

    def gaps(names):
        label_at = _innermost({k: v for k, v in host.items() if k in names})
        out = defaultdict(float)
        end = kernels[0][1] if kernels else 0.0
        for a, b, _ in kernels[1:]:
            if a > end:
                out[label_at(0.5 * (a + end))] += (a - end) / 1e6
            end = max(end, b)
        return dict(sorted(out.items(), key=lambda kv: -kv[1])[:12])

    sl = {"sizes": sizes, "wall_s_off": sl_off.wall_s, "wall_s_on": sl_on.wall_s,
          "bench_off": {"kernels": sl_off.kernels, "busy_s": sl_off.busy_s, "in_range": sl_off.in_range,
                        "idle_gaps": sl_off.idle_gaps},
          "bench_on": {"kernels": sl_on.kernels, "busy_s": sl_on.busy_s, "in_range": sl_on.in_range,
                       "idle_gaps": sl_on.idle_gaps},
          "kernels_without_mirrors": len(kernels), "inside": inside,
          "gaps_ranges_only": gaps(set(RANGES)), "gaps_ranges_and_spans": gaps(set(RANGES) | prog),
          "spans_recorded": len(rec.spans)}
    print(f"[spans] {cell.name} slice: " + json.dumps(sl), flush=True)
    return {"card": card, "cell": cell.name, "seed": args.seed, "setup": setup, "turns": turns, "slice": sl}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", help="a cell of BENCHMARK.json")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--cost", action="store_true", help="time a span, recording off and on, and stop")
    ap.add_argument("--tiny", action="store_true", help="a rehearsal on the CPU at a tiny size")
    ap.add_argument("--out", help="write every part's JSON to this file")
    args = ap.parse_args(argv)
    if args.cost:
        result = {"cost": span_cost()}
    elif args.workload:
        result = measure_cell(args)
    else:
        ap.error("give --workload or --cost")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
