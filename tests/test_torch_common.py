"""Shared helpers of the port's parity tests (this module holds no test).

- Importing it pins torch to one intra-op thread: the suite runs several
  pytest workers side by side, and at the tests' tiny sizes a thread pool per
  worker only makes them fight over the cores.
- `reference_trainer` / `reference_agent` build (and initialise) and cache
  the JAX agent of a task family, so that the tests of one file (one worker) build each agent once.
- `port_agent` builds the port's agent with the JAX agent's params.
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
