"""The rigid_insertion HEPi slice of the PyTorch port as a whole, against the
JAX package: the deterministic rollout, one update phase, and a training
iteration on the CPU.

Both packages build the agent with `build_agent("rigid_insertion", "hepi",
...)` at a small size in f32; the port takes the JAX agent's params,
normaliser state and env state.

Tolerances:
- rollout, 3 steps: 1e-4 relative to each quantity's scale, as
  tests/test_torch_slice.py holds the cloth slice (the policies agree to
  ~1e-6 relative on one input, and the untrained policy's mean actions reach
  ~1e1);
- the update: tests/test_torch_train.py's (params within 1e-6 per Adam step
  taken, aggregated metrics within 1e-4 relative and 1e-5 absolute).
"""

import functools

import jax
import numpy as np
import pytest
import torch
import test_torch_common  # noqa: F401  (pins torch to one thread per test worker)
from test_torch_common import assert_frames_close, render_frames

from geometry_rl_tpu.rl.obs_pipeline import obs_norm_step as jax_obs_norm_step, obs_norm_update
from geometry_rl_tpu.train import TrainConfig as JaxTrainConfig
from geometry_rl_tpu.train.builders import build_agent as jax_build_agent
from geometry_rl_torch.config import load_config, trainer_from_config
from geometry_rl_torch.convert import batch_from_jax, obs_norm_from_jax, params_from_flax, rigid_state_from_jax
from geometry_rl_torch.rl.obs_pipeline import obs_norm_step
from geometry_rl_torch.train import TrainConfig
from geometry_rl_torch.train.builders import build_agent
from geometry_rl_torch.utils.trace import counting

SMALL = dict(num_envs=4, latent_dim=16, num_ori=4)
STEPS = 3
RTOL = 1e-4


def np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def close(got, ref):
    ref = np.asarray(ref)
    return np.abs(np.asarray(got) - ref).max() <= RTOL * max(1.0, np.abs(ref).max())


@functools.lru_cache(maxsize=None)
def agents():
    """(JAX trainer, its state with the normaliser folded once, jitted policy
    and env step, the port's trainer with the same params, its normaliser)."""
    jtr = jax_build_agent("rigid_insertion", "hepi", train_cfg=JaxTrainConfig(steps_per_batch=2, mini_batch_size=4),
                          env_kwargs=dict(warmup_steps=2), **SMALL)
    js = jax.jit(jtr.init)(jax.random.PRNGKey(1))
    js = js._replace(norm=obs_norm_update(js.norm, js.obs))
    ttr = build_agent("rigid_insertion", "hepi", env_kwargs=dict(warmup_steps=2), device="cpu", **SMALL)
    ttr.policy.load_state_dict(params_from_flax(np_tree(js.actor_params)))
    j_policy, j_step = jax.jit(jtr._policy_dist), jax.jit(jtr.env.step)  # jitted: far faster than op by op on the CPU
    return jtr, js, j_policy, j_step, ttr, obs_norm_from_jax(np_tree(js.norm))


@pytest.fixture(scope="module")
def rollouts():
    jtr, js, j_policy, j_step, ttr, t_norm = agents()
    norm = js.norm
    t_env = rigid_state_from_jax(np_tree(js.env_state), torch.Generator().manual_seed(0))
    t_obs = ttr.env.observe(t_env)

    j_env, j_obs = js.env_state, js.obs
    out = []
    with torch.no_grad():
        for _ in range(STEPS):
            _, jtobs = jax_obs_norm_step(norm, j_obs, update=False)
            j_action = j_policy(js.actor_params, jtobs).mean
            j_env, jts = j_step(j_env, j_action)
            j_obs = jts.obs

            _, ttobs = obs_norm_step(t_norm, t_obs, update=False)
            t_action = ttr._policy_dist(ttobs).mean
            t_env, tts = ttr.env.step(t_env, t_action)
            t_obs = tts.obs
            out.append(dict(
                action=(t_action.numpy(), np.asarray(j_action)),
                reward=(tts.reward.numpy(), np.asarray(jts.reward)),
                body_positions=(t_env.scene.bodies.pos.numpy(), np.asarray(j_env.scene.bodies.pos)),
            ))
    return out


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("quantity", ["action", "reward", "body_positions"])
def test_rollout_step_matches_reference(rollouts, step, quantity):
    got, ref = rollouts[step][quantity]
    if quantity == "action":
        assert np.abs(ref).max() > 1e-2  # a non-trivial policy output
    assert close(got, ref), (quantity, np.abs(got - ref).max(), np.abs(ref).max())


def test_render_frames_match_reference():
    """`collect_frames` against the JAX `_collect_frames` (bodies, target,
    object mesh, task distance) from the same state, stopping before env 0's
    episode end, within 1e-5 of scale (measured: bodies equal, mesh 9e-8)."""
    jtr, js, j_policy, j_step, ttr, t_norm = agents()
    assert_frames_close(*render_frames(jtr, js, j_policy, j_step, ttr, t_norm, rigid_state_from_jax), 1e-5)


# ---------------------------------------------------------------- the update

CFG = dict(steps_per_batch=3, mini_batch_size=6, ppo_epochs=2, total_iterations=10)
TINY = dict(num_envs=4, latent_dim=8, num_ori=4)


@pytest.fixture(scope="module")
def updated():
    """One `_update` (2 epochs x 2 minibatches of 6) of each package from the
    JAX agent's collected batch, with the JAX permutations substituted."""
    jtr = jax_build_agent("rigid_insertion", "hepi", train_cfg=JaxTrainConfig(**CFG), env_kwargs=dict(warmup_steps=0),
                          **TINY)
    js = jax.jit(jtr.init)(jax.random.PRNGKey(2))
    js, jbatch, _ = jax.jit(jtr._collect)(js)
    js_new, jm = jax.jit(jtr._update)(js, jbatch)

    ttr = build_agent("rigid_insertion", "hepi", train_cfg=TrainConfig(**CFG), env_kwargs=dict(warmup_steps=0),
                      device="cpu", **TINY)
    state = ttr.init(torch.Generator().manual_seed(0))
    ttr.policy.load_state_dict(params_from_flax(np_tree(js.actor_params)))
    ttr.critic.load_state_dict(params_from_flax(np_tree(js.critic_params)))
    state = state._replace(
        norm=obs_norm_from_jax(np_tree(js.norm)),
        obs={k: torch.as_tensor(np.array(v)) for k, v in js.obs.items()},
        initial_entropy=torch.as_tensor(np.array(js.initial_entropy)),
    )
    key, perms = js.key, []
    n = CFG["steps_per_batch"] * TINY["num_envs"]
    for _ in range(CFG["ppo_epochs"]):
        key, k_perm = jax.random.split(key)
        perms.append(torch.as_tensor(np.array(jax.random.permutation(k_perm, n)[: 2 * 6].reshape(2, 6))))
    perm_iter = iter(perms)
    ttr._permutation = lambda generator, n: next(perm_iter)
    state, tm = ttr._update(state, batch_from_jax(np_tree(jbatch)))
    return ttr, state, tm, js_new, jm


@pytest.mark.parametrize("part", ["policy", "critic"])
def test_update_params_match_reference(updated, part):
    ttr, state, _, js_new, _ = updated
    assert state.num_updates == int(js_new.num_updates) == 4
    ref = params_from_flax(np_tree(getattr(js_new, "actor_params" if part == "policy" else "critic_params")))
    got = getattr(ttr, part).state_dict()
    assert sorted(got) == sorted(ref)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), atol=4 * 1e-6, rtol=0, err_msg=f"{part}.{k}")


def test_update_metrics_match_reference(updated):
    _, _, tm, _, jm = updated
    assert sorted(tm) == sorted(jm)
    for k, v in jm.items():
        np.testing.assert_allclose(tm[k].item(), float(v), rtol=1e-4, atol=1e-5, err_msg=k)


def test_train_iteration_runs_on_cpu():
    """trainer_from_config -> init -> train_iteration at a tiny size: every
    metric finite, the params moved, episodes ended, and neither cloth kernel
    (nor its plain version's counter) touched."""
    cfg = load_config("rigid_insertion_multi_hepi_trpl", overrides={
        "env": {"num_envs": 4, "kwargs": {"warmup_steps": 1, "episode_length": 3}},
        "collector": {"frames_per_batch": 16}, "algorithm": {"latent_dim": 8, "num_ori": 4, "objective": {"mini_batch_size": 8}},
    })
    trainer = trainer_from_config(cfg, device="cpu")
    assert trainer.policy.backbone.dtype == torch.bfloat16  # the config's algorithm.dtype
    with counting("kernels.cloth_solve", "kernels.cloth_solve_env") as launched:
        state = trainer.init(torch.Generator().manual_seed(0))
        before = {k: v.clone() for k, v in trainer.policy.state_dict().items()}
        state, metrics = trainer.train_iteration(state)
    assert state.num_updates == 5 * 2
    assert all(torch.isfinite(v).all() for v in metrics.values()), metrics
    assert metrics["train/episodes"].item() == 4  # one episode end per env in 4 steps of 3
    assert any((trainer.policy.state_dict()[k] - v).abs().max() > 0 for k, v in before.items())
    assert launched == {"kernels.cloth_solve": 0, "kernels.cloth_solve_env": 0}
