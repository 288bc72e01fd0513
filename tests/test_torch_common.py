"""Shared helpers of the port's parity tests (this module holds no test).

- Importing it pins torch to one intra-op thread: the suite runs several
  pytest workers side by side, and at the tests' tiny sizes a thread pool per
  worker only makes them fight over the cores.
- `reference_trainer` / `reference_agent` build (and initialise) and cache
  the JAX agent of a task family, so that the tests of one file (one worker) build each agent once.
- `port_agent` builds the port's agent with the JAX agent's params.
- `render_frames` / `assert_frames_close` hold the port's `collect_frames`
  against the JAX package's `_collect_frames`.
"""

import functools

import jax
import numpy as np
import torch

from geometry_rl_tpu.rl.obs_pipeline import obs_norm_apply as jax_obs_norm_apply
from geometry_rl_tpu.train import TrainConfig as JaxTrainConfig
from geometry_rl_tpu.train.builders import build_agent as jax_build_agent
from geometry_rl_torch.convert import obs_norm_from_jax, params_from_flax
from geometry_rl_torch.train import TrainConfig
from geometry_rl_torch.train.builders import build_agent

torch.set_num_threads(1)

SUBPROCESS_THREADS = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}  # for CLI runs in a child process


def np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def close(got, ref, rtol):
    """max |got - ref| <= rtol * max(1, max |ref|)."""
    ref = np.asarray(ref)
    return np.abs(np.asarray(got) - ref).max() <= rtol * max(1.0, np.abs(ref).max())


def _kw(items):
    return {k: (dict(v) if isinstance(v, tuple) and v and isinstance(v[0], tuple) else v) for k, v in items}


def frozen(**kw):
    """Keyword arguments as a hashable tuple (dict values one level deep)."""
    return tuple(sorted((k, tuple(sorted(v.items())) if isinstance(v, dict) else v) for k, v in kw.items()))


@functools.lru_cache(maxsize=None)
def reference_trainer(task, model, agent_kw=(), train_kw=()):
    """The JAX trainer, not initialised. `agent_kw` / `train_kw` come from
    `frozen(...)`: build_agent's keywords (with `env_kwargs` as a dict) and
    the TrainConfig's fields."""
    kw = _kw(agent_kw)
    if train_kw:
        kw["train_cfg"] = JaxTrainConfig(**dict(train_kw))
    return jax_build_agent(task, model, **kw)


@functools.lru_cache(maxsize=None)
def reference_agent(task, model, agent_kw=(), train_kw=(), seed=1):
    """(JAX trainer, its initial TrainState)."""
    jtr = reference_trainer(task, model, agent_kw, train_kw)
    return jtr, jax.jit(jtr.init)(jax.random.PRNGKey(seed))  # jitted: op by op, the CPU compiles every primitive apart


def port_agent(task, model, js, agent_kw=(), train_kw=(), **extra):
    """The port's trainer on the CPU with the JAX state's params, plus its
    initial TrainState carrying the JAX normaliser, observation and initial
    entropy (fresh Adam states)."""
    kw = {**_kw(agent_kw), **extra}
    if train_kw:
        kw["train_cfg"] = TrainConfig(**dict(train_kw))
    ttr = build_agent(task, model, device="cpu", **kw)
    state = ttr.init(torch.Generator().manual_seed(0))
    ttr.policy.load_state_dict(params_from_flax(np_tree(js.actor_params)))
    ttr.critic.load_state_dict(params_from_flax(np_tree(js.critic_params)))
    state = state._replace(
        norm=obs_norm_from_jax(np_tree(js.norm)),
        obs={k: torch.as_tensor(np.array(v)) for k, v in js.obs.items()},
        initial_entropy=torch.as_tensor(np.array(js.initial_entropy)),
    )
    return ttr, state


def reference_forward(jtr, params, critic_params, tobs):
    """(policy distribution, value) of the JAX agent on `tobs`, jitted."""
    return jax.jit(jtr._policy_dist)(params, tobs), jax.jit(jtr._value)(critic_params, tobs)


def reference_tobs(js):
    """The JAX state's observation, normalised, as (jax dict, torch dict)."""
    tobs = jax_obs_norm_apply(js.norm, js.obs)
    return tobs, {k: torch.as_tensor(np.array(v)) for k, v in tobs.items()}


def render_frames(jtr, js, j_policy, j_step, ttr, t_norm, state_from_jax, n_steps=4, before_end=3):
    """(JAX `_collect_frames`, the port's `collect_frames`) of env 0 over
    `n_steps` deterministic steps from the JAX state `js` (its normaliser
    and params; the port's trainer holds the same params and `t_norm`), with
    env 0 `before_end` steps before its episode ends: both stop there. The
    JAX rollout runs through the caller's jitted `j_policy` and `j_step`."""
    import types

    from geometry_rl_tpu.train import render as jax_render
    from geometry_rl_torch.train.render import collect_frames

    steps = js.env_state.episode_step
    env0 = js.env_state._replace(episode_step=steps.at[0].set(jtr.env.cfg.episode_length - before_end))

    from geometry_rl_tpu.rl import obs_pipeline as jax_obs_pipeline
    from geometry_rl_tpu.utils import math as jax_math

    j_observe = jax.jit(jtr.env.observe)

    class Env:  # the JAX env, resetting to env0, observing and stepping jitted
        def reset(self, key):
            return env0

        def observe(self, state):
            return j_observe(state)

        def step(self, state, action):
            return j_step(state, action)

        def __getattr__(self, name):
            return getattr(jtr.env, name)

    # the functions `_collect_frames` imports, jitted for the call: op by op
    # the CPU compiles every primitive apart
    originals = {(jax_obs_pipeline, "obs_norm_step"): jax_obs_pipeline.obs_norm_step,
                 (jax_math, "transform_points"): jax_math.transform_points}
    jax_obs_pipeline.obs_norm_step = jax.jit(jax_obs_pipeline.obs_norm_step, static_argnames="update")
    jax_math.transform_points = jax.jit(jax_math.transform_points)
    try:
        jframes = jax_render._collect_frames(types.SimpleNamespace(env=Env(), _policy_dist=j_policy), js, n_steps, 0)
    finally:
        for (module, name), fn in originals.items():
            setattr(module, name, fn)
    t_env0 = state_from_jax(np_tree(env0), torch.Generator().manual_seed(0))
    ttr.env.reset = lambda generator: t_env0
    try:
        tframes = collect_frames(ttr, types.SimpleNamespace(generator=torch.Generator().manual_seed(0), norm=t_norm), n_steps)
    finally:
        del ttr.env.reset
    return jframes, tframes


def assert_frames_close(jframes, tframes, rtol, before_end=3):
    """The same frames (one per step before the episode's end), each entry
    within `rtol` of max(1, scale)."""
    assert len(tframes) == len(jframes) == before_end - 1
    for jf, tf in zip(jframes, tframes):
        assert sorted(tf) == sorted(jf)
        for k, v in jf.items():
            if k == "mesh_mask":
                np.testing.assert_array_equal(tf[k], v)
            else:
                assert close(tf[k], v, rtol), (k, np.abs(np.asarray(tf[k]) - np.asarray(v)).max())
