"""The port's benchmark (port of `bench.py`): rigid_insertion HEPi collection
env-steps/s, cloth_hanging collection env-steps/s and one full rigid_insertion
`train_iteration` (collect, GAE, 5 epochs of minibatch steps) with its frames/s
and MFU, printed as one JSON line in `bench.py`'s shape:
{"metric", "value", "unit", "vs_baseline", "extra"}.

    python -m geometry_rl_torch.tools.bench                        # bench.py's sizes, on the card
    python -m geometry_rl_torch.tools.bench --tiny --device cpu    # bench.py's GEOMRL_BENCH_TINY sizes

`--tiny` (or GEOMRL_BENCH_TINY=1) takes 8 envs, 4 steps, latent 16, 4
orientations and one timed run. `--steps` and `--runs` cut the depth at full
width. `--device` defaults to `cuda` and raises where there is no card.

`vs_baseline` is null: bench.py's 50,000 env-steps/s is a target set for
another accelerator, and none is set for the card. `extra` carries the card's
power limit (nvidia-smi), which bounds every number here. Times are host
clock seconds, each window ending in a device synchronize; the first run of
each measurement is an untimed warm-up, and the first of them builds the
kernels (`extra["nvcc_builds"]`: the libraries nvcc compiled, 0 where every
build was reused).
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import subprocess
import time

import torch

from ..rl import gaussian as G
from ..rl.obs_pipeline import obs_norm_step

METRIC = "rigid_insertion_hepi_collection_env_steps_per_sec"
# peak dense bf16 FLOP/s by device name: NVIDIA's data sheet for the H100 SXM at 700 W
PEAK_FLOPS = {"NVIDIA H100 80GB HBM3": 989e12}
# bench.py's envs, control steps and timed runs per measurement, and HEPi's widths (TINY: GEOMRL_BENCH_TINY's)
FULL = dict(rigid_envs=1024, cloth_envs=256, iteration_envs=1024, collection_steps=50, iteration_steps=100,
            collection_runs=3, iteration_runs=2, latent_dim=64, num_ori=16)
TINY = dict(rigid_envs=8, cloth_envs=8, iteration_envs=8, collection_steps=4, iteration_steps=4,
            collection_runs=1, iteration_runs=1, latent_dim=16, num_ori=4)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_kind(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def power_limit_w() -> float:
    """The first card's power limit in watts, as nvidia-smi reports it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.split()[0])


def timed(run, carry, n_runs: int, device: torch.device):
    """Seconds per run of `carry = run(carry)`, after one untimed warm-up run
    (which builds the kernels at first use); each run continues from the
    last one's carry. Returns (seconds per run, the last carry)."""
    carry = run(carry)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(n_runs):
        carry = run(carry)
    sync(device)
    return (time.perf_counter() - t0) / n_runs, carry


def build(task: str, num_envs: int, steps: int, device, latent_dim: int = 64, num_ori: int = 16, env_kwargs=None):
    """bench.py's agent: HEPi, TRPL, 5 epochs of minibatches of 1000, bf16."""
    from ..train import TrainConfig
    from ..train.builders import build_agent

    return build_agent(
        task=task,
        model="hepi",
        num_envs=num_envs,
        latent_dim=latent_dim,
        num_ori=num_ori,
        train_cfg=TrainConfig(steps_per_batch=steps, ppo_epochs=5, mini_batch_size=1000),
        env_kwargs={"warmup_steps": 0} if env_kwargs is None else env_kwargs,
        dtype=torch.bfloat16,
        device=device,
    )


@torch.no_grad()
def act(trainer, norm, obs):
    """The collection loop's deterministic part: the normaliser's update,
    the policy's graph and its distribution. Returns (norm, tobs, dist)."""
    norm, tobs = obs_norm_step(norm, obs, update=True)
    graph, feats = trainer.policy_builder.build(tobs)
    return norm, tobs, trainer.policy(graph, feats)


@torch.no_grad()
def collection_step(trainer, carry, generator: torch.Generator):
    """One control step of bench.py's collection loop (`bench.py:84-96`):
    carry (env_state, obs, norm) -> (the next carry, the reward)."""
    env_state, obs, norm = carry
    norm, _, dist = act(trainer, norm, obs)
    env_state, ts = trainer.env.step(env_state, G.sample(generator, dist))
    return (env_state, ts.obs, norm), ts.reward


def bench_collection(task: str, num_envs: int, steps: int, n_runs: int = 3, device="cuda", latent_dim: int = 64,
                     num_ori: int = 16, env_kwargs=None) -> float:
    """env-steps/s of the collection loop (physics, observation pipeline,
    graph build, HEPi forward, sampling), eager under `torch.no_grad`:
    `n_runs` timed runs of `steps` control steps after a warm-up run."""
    device = torch.device(device)
    trainer = build(task, num_envs, steps, device, latent_dim, num_ori, env_kwargs)
    state = trainer.init(torch.Generator(device=device).manual_seed(0))
    generator = torch.Generator(device=device).manual_seed(0)  # the actions' draws

    def run(carry):
        for _ in range(steps):
            carry, _ = collection_step(trainer, carry, generator)
        return carry

    dt, _ = timed(run, (state.env_state, state.obs, state.norm), n_runs, device)
    return steps * num_envs / dt


def count_flops(fn, *args, **kwargs):
    """(FLOPs that `FlopCounterMode` counts in `fn(*args, **kwargs)`, its result)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        out = fn(*args, **kwargs)
    return counter.get_total_flops(), out


def with_steps(trainer, steps: int):
    """`trainer` with a collect of `steps` control steps (the same env, modules and builders)."""
    short = copy.copy(trainer)
    short.cfg = dataclasses.replace(trainer.cfg, steps_per_batch=steps)
    return short


def flops_per_iteration(trainer, state) -> float:
    """FLOPs of one `train_iteration`, counted as bench.py counts them
    (`bench.py:151-183`): one minibatch step (forward, backward, Adam)
    times ppo_epochs x num_minibatches, plus one control step of `_collect`
    times steps_per_batch. Both run through the trainer's own code and
    advance `state`'s env, params and Adam states.

    `FlopCounterMode` counts the matrix products, batched products and
    convolutions that PyTorch dispatches, 2·M·N·K each. It leaves out the
    elementwise ops, the KL projection's bisection (elementwise) and the
    kernels launched through ctypes (the cloth solves, the segment sum),
    which PyTorch never sees. The count is not comparable with bench.py's
    XLA count, which includes the one-hot matmul lowerings of the message
    sums (`geometry_rl_tpu/models/common.py:54-90`) that the port replaced
    with its segment-sum kernel."""
    cfg, B = trainer.cfg, trainer.env.cfg.num_envs
    collect, (state, batch, _) = count_flops(with_steps(trainer, 1)._collect, state)
    short = with_steps(trainer, -(-trainer.mini_batch_size // B))  # the control steps one minibatch needs
    if short.cfg.steps_per_batch > 1:
        state, batch, _ = short._collect(state)
    mb = trainer._minibatch(short._update_data(state, batch), torch.arange(trainer.mini_batch_size, device=trainer.device))
    update, _ = count_flops(trainer._minibatch_step, state, mb, state.num_updates, state.kl_beta)
    return update * cfg.ppo_epochs * trainer.num_minibatches + collect * cfg.steps_per_batch


def bench_train_iteration(task: str = "rigid_insertion", num_envs: int = 1024, steps: int = 100, n_runs: int = 2,
                          device="cuda", latent_dim: int = 64, num_ori: int = 16) -> dict:
    """Seconds, frames/s and the collect / update split (the trainer's own
    `train/collect_time` / `train/update_time`) of the full `train_iteration`
    at reference scale, after a warm-up iteration; `mfu` and `flops_per_iter`
    where the card's peak is in PEAK_FLOPS (the count taken after the timed
    iterations: `flops_per_iteration`)."""
    device = torch.device(device)
    trainer = build(task, num_envs, steps, device, latent_dim, num_ori)
    halves = []  # (collect s, update s) of each iteration, the warm-up's first

    def run(state):
        state, metrics = trainer.train_iteration(state)
        halves.append((float(metrics["train/collect_time"]), float(metrics["train/update_time"])))
        return state

    dt, state = timed(run, trainer.init(torch.Generator(device=device).manual_seed(0)), n_runs, device)
    split = dict(zip(("collect_s", "update_s"), (sum(h) / n_runs for h in zip(*halves[1:]))))
    result = {"iteration_s": dt, "frames_per_sec": steps * num_envs / dt, **split}
    flops = flops_per_iteration(trainer, state)
    peak = PEAK_FLOPS.get(device_kind(device))
    if peak:
        result["mfu"] = flops / dt / peak
        result["flops_per_iter"] = flops
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--tiny", action="store_true", help="bench.py's tiny sizes (also GEOMRL_BENCH_TINY=1)")
    ap.add_argument("--steps", type=int, default=None, help="control steps of every measurement (default 50 per "
                    "collection, 100 per iteration)")
    ap.add_argument("--runs", type=int, default=None, help="timed runs of every measurement (default 3 per "
                    "collection, 2 per iteration)")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    from ..train.cli import resolve_device
    from ..utils.trace import COUNTERS

    device = resolve_device(args.device)
    size = dict(TINY if args.tiny or os.environ.get("GEOMRL_BENCH_TINY") == "1" else FULL)
    if args.steps is not None:
        size.update(collection_steps=args.steps, iteration_steps=args.steps)
    if args.runs is not None:
        size.update(collection_runs=args.runs, iteration_runs=args.runs)
    widths = dict(device=device, latent_dim=size["latent_dim"], num_ori=size["num_ori"])
    rigid = bench_collection("rigid_insertion", size["rigid_envs"], size["collection_steps"], size["collection_runs"],
                             **widths)
    cloth = bench_collection("cloth_hanging", size["cloth_envs"], size["collection_steps"], size["collection_runs"],
                             **widths)
    update = bench_train_iteration(num_envs=size["iteration_envs"], steps=size["iteration_steps"],
                                   n_runs=size["iteration_runs"], **widths)
    extra = {
        "cloth_hanging_collection_env_steps_per_sec": cloth,
        "rigid_insertion_train_iteration": update,
        "n_devices": 1,  # one device: the JAX bench's env-axis sharding (`_shard`) is not ported
        "device_kind": device_kind(device),
        "baseline": "none set for the card",
        "sizes": size,
        # the first warm-up run's kernel builds (0: reused from geometry_rl_torch/_build/), outside every timed run
        "nvcc_builds": COUNTERS.get("setup.nvcc_builds", 0),
    }
    if device.type == "cuda":
        extra["power_limit_w"] = power_limit_w()
    record = {"metric": METRIC, "value": rigid, "unit": "env-steps/sec", "vs_baseline": None, "extra": extra}
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
