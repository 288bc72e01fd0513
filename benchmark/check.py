"""The comparison that decides `correct`: the port's own outputs, captured
from its run (`capture.py`), against the plain reference (`reference/`),
which makes its own weights, normaliser and draws from the run's seed.

Each number is a gap; the cell's file (`check.limits`) gives each a limit,
and a run is correct when every number is finite and within its limit.

Train cells judge two `train_iteration` calls, each number the larger of
the two: set-up's first, from the seed (the reference makes its own
weights, normaliser and draws), and one more once the window has closed,
from the port's own state at its start (parameters, Adam's state,
normaliser, generator and env state; the update count is the reference's
own, iterations so far x minibatch steps an iteration). Both are the
window's call and feed. Numbers:
- `policy`: the behaviour distribution's mean and std, the critic's value
  and the sampled action at every control step, against the reference's
  forward (on its own normaliser, run over the port's raw observations) and
  its own draw from the generator; each env's gap over the larger of that
  env's scale and the median env's (`env_gap`), so that one env's wrong
  answer shows;
- `env`: at control steps drawn from the seed, the env step taken again by
  the reference from the port's input state and action: the next
  observation's positions and scalars, the reward, the done flags and the
  state the step returns (positions, orientations, counters, generator);
- `env_velocity`: the same steps' velocities, in the observation
  (`velocity_vectors`) and in the returned state (`VELOCITY_FIELDS`);
- `loss`: the total loss of the update's first three minibatch steps;
- `grad`: the norm of each leaf's first gradient as Adam got it (from its
  state before and after the step), the worst leaf's gap over the larger of
  the reference's norm of that leaf and the median leaf's;
- `change`: the norm of each leaf's change over the three steps, the same
  way, over the leaves whose reference gradient is not nought to rounding
  (at least a thousandth of the median leaf's).
The reference follows the update from the port's collected batch (its raw
observations, actions, rewards and done flags): `policy` and `env`
check that stage by itself.

Rollout cells (the capture is the window's own steps):
- `policy`: the deterministic action at the steps drawn from the seed, per
  env as above;
- `env`, `env_velocity`: at those steps and at the first (from the reset's
  state), the observation the policy read and the env step taken again from
  the port's input state.

The reset's own state is not compared: on cloth it is ten settling solves
run free on each side, kernel against plain solve, which drift apart through
contact (1e-3 to 1e-2 of the positions, against 1e-6 for one step from the
same state).

A tensor gap is max |port - reference| over max |reference|. Velocities
are a number of their own: the simulators derive them from two positions
over the time step, so a velocity's rounding is a position's times 1 / dt
(100 on cloth), and they would set `env`'s limit a hundredfold wider.
"""

from __future__ import annotations

import statistics
from typing import Dict, Tuple

import torch

from . import reference
from .capture import MINIBATCH_STEPS, snapshot
from .reference import copy_generator, to_reference
from .reference.frozen.rl import gaussian as G
from .reference.frozen.rl.obs_pipeline import obs_norm_step
from .reference.frozen.train.ppo import Batch

INF = float("inf")


def rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.shape != b.shape:
        return INF
    a, b = a.double(), b.double()
    gap = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30) if b.numel() else 0.0
    return gap if gap == gap else INF


def env_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """The worst env's max |a - b| over the larger of that env's max |b| and
    the median env's (the leading axis is the envs')."""
    if a.shape != b.shape:
        return INF
    if not b.numel():
        return 0.0
    a, b = a.double().reshape(b.shape[0], -1), b.double().reshape(b.shape[0], -1)
    scale = b.abs().amax(dim=1)
    floor = max(float(scale.median()), 1e-30)
    gap = float(((a - b).abs().amax(dim=1) / scale.clamp(min=floor)).max())
    return gap if gap == gap else INF


VELOCITIES = "velocity_vectors"  # the observation group of velocities
VELOCITY_FIELDS = ("vel", "lin_vel", "ang_vel")  # the state's velocities (`sim/types.py`)


def obs_gaps(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]) -> Tuple[float, float]:
    """(the gap of every group but the velocities, the velocities' gap)."""
    if set(a) != set(b):
        return INF, INF
    rest = max((rel_gap(a[k], b[k]) for k in a if k != VELOCITIES), default=0.0)
    return rest, (rel_gap(a[VELOCITIES], b[VELOCITIES]) if VELOCITIES in a else 0.0)


def state_gaps(a, b, field: str = "") -> Tuple[float, float]:
    """(the gap of every field but the velocities, the velocities' gap) of
    two env states, NamedTuples matched field by field: floating tensors by
    `rel_gap`, integer tensors and generators exactly."""
    if isinstance(b, torch.Tensor):
        if not isinstance(a, torch.Tensor) or a.shape != b.shape or a.dtype != b.dtype:
            return INF, INF
        if not b.is_floating_point():
            return (0.0 if torch.equal(a.cpu(), b.cpu()) else INF), 0.0
        gap = rel_gap(a, b)
        return (0.0, gap) if field in VELOCITY_FIELDS else (gap, 0.0)
    if isinstance(b, torch.Generator):
        same = isinstance(a, torch.Generator) and torch.equal(a.get_state(), b.get_state())
        return (0.0 if same else INF), 0.0
    if isinstance(b, tuple) and hasattr(b, "_fields"):
        if getattr(a, "_fields", None) != b._fields:
            return INF, INF
        gaps = [state_gaps(getattr(a, f), getattr(b, f), f) for f in b._fields]
        return max((g[0] for g in gaps), default=0.0), max((g[1] for g in gaps), default=0.0)
    return (0.0, 0.0) if a is None and b is None else (INF, INF)


def step_gaps(sample: Dict, state_ref, ts_ref) -> Tuple[float, float]:
    """(env, env_velocity) of one captured env step against the reference's
    step from the same input state and action."""
    ts = sample["ts"]
    if not torch.equal(ts.done.cpu(), ts_ref.done.cpu()):
        return INF, INF
    obs, obs_vel = obs_gaps(ts.obs, ts_ref.obs)
    st, st_vel = state_gaps(sample["next"], state_ref)
    return max(obs, st, rel_gap(ts.reward, ts_ref.reward)), max(obs_vel, st_vel)


def leaf_gap(port: Dict[str, float], ref: Dict[str, float]) -> float:
    """The worst leaf's |port - ref| over the larger of ref and the median leaf's ref."""
    if not ref:
        return INF
    med = statistics.median(ref.values())
    return max(abs(port.get(k, 0.0) - r) / max(r, med, 1e-30) for k, r in ref.items())


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def _flat(groups: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {f"{g}/{k}": v for g, d in groups.items() for k, v in d.items()}


def _ref_params(ref) -> Dict[str, Dict[str, torch.Tensor]]:
    return {"policy": {k: v.detach().clone() for k, v in ref.policy.named_parameters()},
            "critic": {k: v.detach().clone() for k, v in ref.critic.named_parameters()}}


def from_port_state(ref, rs, start: Dict, num_updates: int):
    """The reference's state `rs` carried over to the port's at an
    iteration's start: its modules' parameters and buffers, Adam's state,
    normaliser, generator, env state and observation; the update count is
    the reference's own."""
    for group, module, opt in (("policy", ref.policy, rs.actor_opt), ("critic", ref.critic, rs.critic_opt)):
        module.load_state_dict(start["modules"][group])
        for name, p in module.named_parameters():
            if name in start["adam"][group]:
                opt.state[p] = {k: v.clone() for k, v in start["adam"][group][name].items()}
    return rs._replace(norm=to_reference(start["norm"]), env_state=to_reference(start["env_state"]),
                       obs=start["obs"], generator=copy_generator(start["generator"]), num_updates=num_updates)


def judge_train(cfg: Dict, seed: int, cap: Dict, device) -> Dict[str, float]:
    """One captured iteration: from the seed, or where the capture holds
    `start`, from the port's state at its start."""
    ref = reference.build(cfg, device)
    rs = ref.init(torch.Generator(device=device).manual_seed(seed))
    on = lambda x: snapshot(x, device)  # noqa: E731
    if "start" in cap:
        per_iteration = ref.cfg.ppo_epochs * ref.num_minibatches
        rs = from_port_state(ref, rs, on(cap["start"]), cap["iterations_before"] * per_iteration)
    batch = on(cap["batch"])
    obs_seq = [on(cap["obs0"])] + [on(o) for o in cap["step_obs"]]
    env = velocity = policy = 0.0
    norm, gen = rs.norm, rs.generator
    steps = []
    with torch.no_grad():
        for t in range(ref.cfg.steps_per_batch):
            norm, tobs = obs_norm_step(norm, obs_seq[t], update=True)
            dist = ref._policy_dist(tobs)
            action = G.sample(gen, dist)
            value = ref._value(tobs)
            policy = max(policy, env_gap(batch.mean[t], dist.mean), env_gap(batch.std[t], dist.std),
                         env_gap(batch.value[t], value), env_gap(batch.action[t], action))
            steps.append((tobs, G.log_prob(dist, batch.action[t]), dist.mean, dist.std, value))
        for s in cap["samples"]:
            state_ref, ts = ref.env.step(to_reference(on(s["state"])), on(s["action"]))
            e, v = step_gaps(on(s), state_ref, ts)
            env, velocity = max(env, e), max(velocity, v)
    tobs, log_prob, mean, std, value = zip(*steps)
    batch_r = Batch({k: torch.stack([o[k] for o in tobs]) for k in tobs[0]}, batch.action, torch.stack(log_prob),
                    torch.stack(mean), torch.stack(std), torch.stack(value), batch.reward, batch.done)
    state = rs._replace(norm=norm, obs=on(cap["final_obs"]), generator=gen)
    data = ref._update_data(state, batch_r)
    minibatches = []  # the first three of the update's epochs' permutations
    while len(minibatches) < MINIBATCH_STEPS:
        minibatches.extend(ref._permutation(gen, data["action"].shape[0]))
    losses = []
    mb_loss = ref._minibatch_loss

    def recorded_loss(*args, **kwargs):
        loss, aux = mb_loss(*args, **kwargs)
        losses.append(float(loss.detach()))
        return loss, aux

    ref._minibatch_loss = recorded_loss
    p0 = _ref_params(ref)
    g1 = None
    for k in range(MINIBATCH_STEPS):
        ref._minibatch_step(state, ref._minibatch(data, minibatches[k]), state.num_updates + k, state.kl_beta)
        if k == 0:
            g1 = {"policy": {n: p.grad.clone() for n, p in ref.policy.named_parameters() if p.grad is not None},
                  "critic": {n: p.grad.clone() for n, p in ref.critic.named_parameters() if p.grad is not None}}
    p3 = _ref_params(ref)
    del ref._minibatch_loss

    port_losses = [float(x) for x in cap["losses"]]
    loss = INF if len(port_losses) != len(losses) else max(
        (abs(a - b) / max(abs(b), 1e-30) for a, b in zip(port_losses, losses)), default=INF)
    g_ref, g_port = _norms(_flat(g1)), _norms(_flat(cap["g1"]))
    grad = leaf_gap(g_port, g_ref)
    med_g = statistics.median(g_ref.values())
    moved = [k for k, v in g_ref.items() if v >= 1e-3 * med_g]
    p0_port, p3_port, p0_ref, p3_ref = (_flat(p) for p in (cap["p0"], cap["p3"], p0, p3))
    d_ref = {k: float((p3_ref[k].double() - p0_ref[k].double()).norm()) for k in moved}
    d_port = {k: float((p3_port[k].double() - p0_port[k].double()).norm()) for k in moved if k in p3_port}
    change = leaf_gap(d_port, d_ref)
    return {"policy": policy, "env": env, "env_velocity": velocity, "loss": loss, "grad": grad, "change": change}


def judge_rollout(cfg: Dict, seed: int, cap: Dict, device) -> Dict[str, float]:
    ref = reference.build(cfg, device)
    rs = ref.init(torch.Generator(device=device).manual_seed(seed))
    on = lambda x: snapshot(x, device)  # noqa: E731
    samples = cap["samples"]
    if not samples or samples[0]["index"] != 0:
        return {"policy": INF, "env": INF, "env_velocity": INF}
    env = velocity = policy = 0.0
    with torch.no_grad():
        for s in samples:
            s = on(s)
            state = to_reference(s["state"])
            obs_ref = ref.env.observe(state)
            obs_in = obs_ref if s["obs"] is None else s["obs"]
            e, v = obs_gaps(obs_in, obs_ref)
            _, tobs = obs_norm_step(rs.norm, obs_in, update=False)
            policy = max(policy, env_gap(s["action"], ref._policy_dist(tobs).mean))
            state_ref, ts = ref.env.step(state, s["action"])
            e2, v2 = step_gaps(s, state_ref, ts)
            env, velocity = max(env, e, e2), max(velocity, v, v2)
    return {"policy": policy, "env": env, "env_velocity": velocity}


def judge(cell, cfg: Dict, seed: int, cap: Dict, device, log=None) -> Dict[str, Dict[str, float]]:
    """{number: {"value", "limit"}} for the cell's loop; a train cell's
    number is the larger of its two iterations' (each passed to `log`)."""
    if cell.loop == "train":
        parts = {part: judge_train(cfg, seed, cap[part], device) for part in ("first", "last")}
        if log is not None:
            for part, numbers in parts.items():
                log(f"check, {part} iteration: {numbers}")
        numbers = {k: max(p[k] for p in parts.values()) for k in parts["first"]}
    else:
        numbers = judge_rollout(cfg, seed, cap, device)
    limits = cell.spec["check"]["limits"]
    return {k: {"value": v, "limit": float(limits[k])} for k, v in numbers.items()}


def is_correct(numbers: Dict[str, Dict[str, float]]) -> bool:
    return all(n["value"] <= n["limit"] for n in numbers.values())
