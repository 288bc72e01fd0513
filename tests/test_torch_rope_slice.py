"""The rope HEPi slices of the PyTorch port as a whole, against the JAX package:
the deterministic rollout of both tasks, one update phase, a training
iteration on the CPU, and the CLIs.

Both packages build the agent with `build_agent(task, "hepi", ...)` at a
small size in f32; the port takes the JAX agent's params, normaliser state
and env state.

Tolerances:
- rollout, 3 steps: 1e-4 relative to each quantity's scale, as
  tests/test_torch_rigid_slice.py holds the rigid slice. The shaping reward
  is a mean of squared shape-descriptor differences whose angle entries take
  `arccos` next to 1 on the still nearly straight rope (conditioning ~2e2,
  tests/test_torch_rope_env.py), so it is held at 1e-3 of its scale;
- the update: tests/test_torch_train.py's (params within 1e-6 per Adam step
  taken, aggregated metrics within 1e-4 relative and 1e-5 absolute).
"""

import functools
import json
import os

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
from geometry_rl_torch.convert import batch_from_jax, obs_norm_from_jax, params_from_flax, rope_state_from_jax
from geometry_rl_torch.rl.obs_pipeline import obs_norm_step
from geometry_rl_torch.train import TrainConfig, cli, play
from geometry_rl_torch.train.builders import build_agent
from geometry_rl_torch.utils.trace import counting

SMALL = dict(num_envs=4, latent_dim=16, num_ori=4)
ENV_KW = dict(num_links=12, rope_length=1.5, warmup_steps=2)
STEPS = 3
RTOL = 1e-4
SHAPING_REWARD_RTOL = 1e-3
TASKS = ["rope_closing", "rope_shaping"]


def np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def close(got, ref, rtol=RTOL):
    ref = np.asarray(ref)
    return np.abs(np.asarray(got) - ref).max() <= rtol * max(1.0, np.abs(ref).max())


@functools.lru_cache(maxsize=None)
def agents(task):
    """(JAX trainer, its state with the normaliser folded once, jitted policy
    and env step, the port's trainer with the same params, its normaliser)."""
    jtr = jax_build_agent(task, "hepi", train_cfg=JaxTrainConfig(steps_per_batch=2, mini_batch_size=4), env_kwargs=ENV_KW, **SMALL)
    js = jax.jit(jtr.init)(jax.random.PRNGKey(1))
    js = js._replace(norm=obs_norm_update(js.norm, js.obs))
    ttr = build_agent(task, "hepi", env_kwargs=ENV_KW, device="cpu", **SMALL)
    ttr.policy.load_state_dict(params_from_flax(np_tree(js.actor_params)))
    j_policy, j_step = jax.jit(jtr._policy_dist), jax.jit(jtr.env.step)  # jitted: far faster than op by op on the CPU
    return jtr, js, j_policy, j_step, ttr, obs_norm_from_jax(np_tree(js.norm))


@pytest.fixture(scope="module", params=TASKS)
def rollouts(request):
    task = request.param
    jtr, js, j_policy, j_step, ttr, t_norm = agents(task)
    norm = js.norm
    t_env = rope_state_from_jax(np_tree(js.env_state), torch.Generator().manual_seed(0))
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
                link_positions=(t_env.scene.particles.pos.numpy(), np.asarray(j_env.scene.particles.pos)),
                gripper_positions=(t_env.scene.bodies.pos.numpy(), np.asarray(j_env.scene.bodies.pos)),
            ))
    return task, out


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("quantity", ["action", "reward", "link_positions", "gripper_positions"])
def test_rollout_step_matches_reference(rollouts, step, quantity):
    task, out = rollouts
    got, ref = out[step][quantity]
    if quantity == "action":
        assert np.abs(ref).max() > 1e-2  # a non-trivial policy output
    rtol = SHAPING_REWARD_RTOL if (task, quantity) == ("rope_shaping", "reward") else RTOL
    assert close(got, ref, rtol), (quantity, np.abs(got - ref).max(), np.abs(ref).max())


# ---------------------------------------------------------------- the update

CFG = dict(steps_per_batch=3, mini_batch_size=6, ppo_epochs=2, total_iterations=10)
TINY = dict(num_envs=4, latent_dim=8, num_ori=4)
TINY_ENV = dict(num_links=10, rope_length=1.25, warmup_steps=0)


def test_render_frames_match_reference():
    """`collect_frames` against the JAX `_collect_frames` on rope_closing
    (grippers, links, the pole, task distance) from the same state, stopping
    before env 0's episode end, within 1e-5 of scale."""
    jtr, js, j_policy, j_step, ttr, t_norm = agents("rope_closing")
    assert_frames_close(*render_frames(jtr, js, j_policy, j_step, ttr, t_norm, rope_state_from_jax), 1e-5)


@pytest.fixture(scope="module")
def updated():
    """One `_update` (2 epochs x 2 minibatches of 6) of each package from the
    JAX agent's collected rope_closing batch, with the JAX permutations
    substituted, and closing's projection bounds."""
    proj = dict(trust_region_coeff=4.0, cov_bound=0.001)
    jtr = jax_build_agent("rope_closing", "hepi", train_cfg=JaxTrainConfig(**CFG), env_kwargs=TINY_ENV, **proj, **TINY)
    js = jax.jit(jtr.init)(jax.random.PRNGKey(2))
    js, jbatch, _ = jax.jit(jtr._collect)(js)
    js_new, jm = jax.jit(jtr._update)(js, jbatch)

    ttr = build_agent("rope_closing", "hepi", train_cfg=TrainConfig(**CFG), env_kwargs=TINY_ENV, device="cpu", **proj, **TINY)
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


@pytest.mark.parametrize("name", ["rope_closing_hepi_trpl", "rope_shaping_hepi_trpl"])
def test_train_iteration_runs_on_cpu(name):
    """trainer_from_config -> init -> train_iteration at a tiny size: every
    metric finite, the params moved, episodes ended, and neither cloth kernel
    (nor its plain version's counter) touched."""
    cfg = load_config(name, overrides={
        "env": {"num_envs": 4, "kwargs": {"warmup_steps": 1, "episode_length": 3, "num_links": 10, "rope_length": 1.25}},
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


def test_cli_run_and_play(tmp_path):
    """The training CLI on a tiny rope_closing run, then play on its checkpoint."""
    run = cli.main(["--config", "rope_closing_hepi_trpl", "--device", "cpu", "--override", "env.num_envs=4",
                    "env.kwargs.num_links=10", "env.kwargs.rope_length=1.25", "env.kwargs.episode_length=6",
                    "collector.frames_per_batch=24", "collector.total_frames=48", "algorithm.latent_dim=8", "algorithm.num_ori=4",
                    "algorithm.objective.mini_batch_size=12", "logger.checkpoint.save_interval=1", f"logger.log_dir={tmp_path}"])
    with open(os.path.join(run, "hparams.json")) as f:
        hparams = json.load(f)
    assert hparams["task"] == "rope_closing" and hparams["algorithm"]["projection"]["trust_region_coeff"] == 4.0
    with open(os.path.join(run, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert len(rows) == 2 and all(np.isfinite(r["train/reward"]) and np.isfinite(r["kl"]) for r in rows)
    res = play.main(["--run-dir", run, "--checkpoint", "checkpoints", "--episodes-steps", "6", "--success-threshold", "0.1",
                     "--device", "cpu"])
    entry = res[sorted(res)[-1]]
    assert 0.0 <= entry["success_rate"] <= 1.0 and np.isfinite(entry["mean_final_distance"])
    assert os.path.exists(os.path.join(run, "eval.json"))
