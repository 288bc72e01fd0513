"""The cloth_hanging HEPi rollout slice of the PyTorch port as a whole.

Both packages build the agent with `build_agent("cloth_hanging", "hepi", ...)`
at a small size; the port takes the JAX agent's params, normaliser state and
env state, and both run the deterministic (mean-action) loop of
`eval_rollout` for 3 steps.
"""

import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import test_torch_common  # noqa: F401  (pins torch to one thread per test worker)
from test_torch_common import assert_frames_close, render_frames

from geometry_rl_tpu.rl.obs_pipeline import obs_norm_step as jax_obs_norm_step, obs_norm_update
from geometry_rl_tpu.train import TrainConfig as JaxTrainConfig
from geometry_rl_tpu.train.builders import build_agent as jax_build_agent
from geometry_rl_torch.config import load_config, trainer_from_config
from geometry_rl_torch.convert import cloth_state_from_jax, obs_norm_from_jax, params_from_flax
from geometry_rl_torch.rl.obs_pipeline import obs_norm_step
from geometry_rl_torch.train.builders import build_agent
from geometry_rl_torch.train.ppo import fold_in, split_generator
from geometry_rl_torch.utils.trace import counting

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(num_envs=2, latent_dim=16, num_ori=4)
STEPS = 3
# Relative to each quantity's scale (max(1, max |reference|)): the policies
# agree to ~1e-6 relative on one input (tests/test_torch_hepi.py), the
# untrained policy's mean actions reach ~1e2 (the action-rate reward term
# squares them), and cloth contact amplifies a state gap about 3x per step
# (tests/test_golden_trajectories.py), so 3 free-running steps get 1e-4.
RTOL = 1e-4


def close(got, ref):
    ref = np.asarray(ref)
    return np.abs(np.asarray(got) - ref).max() <= RTOL * max(1.0, np.abs(ref).max())


@functools.lru_cache(maxsize=None)
def agents():
    """(JAX trainer, its state with the normaliser folded once, its jitted
    policy and its env step (the Pallas kernel in interpret mode), the
    port's trainer with the same params, its normaliser)."""
    jtr = jax_build_agent(
        "cloth_hanging", "hepi", train_cfg=JaxTrainConfig(steps_per_batch=2, mini_batch_size=4),
        env_kwargs=dict(warmup_steps=0, use_pallas_solver="tiled"), **SMALL,
    )
    js = jax.jit(jtr.init)(jax.random.PRNGKey(1))
    js = js._replace(norm=obs_norm_update(js.norm, js.obs))
    ttr = build_agent("cloth_hanging", "hepi", env_kwargs=dict(warmup_steps=0), device="cpu", **SMALL)
    ttr.policy.load_state_dict(params_from_flax(np_tree(js.actor_params)))
    j_policy = jax.jit(jtr._policy_dist)  # jitted: far faster than op by op on the CPU
    return jtr, js, j_policy, jtr.env.step, ttr, obs_norm_from_jax(np_tree(js.norm))


def np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module")
def rollouts():
    jtr, js, j_policy, _, ttr, t_norm = agents()
    norm = js.norm
    t_env = cloth_state_from_jax(np_tree(js.env_state), torch.Generator().manual_seed(0))
    t_obs = ttr.env.observe(t_env)

    j_env, j_obs = js.env_state, js.obs
    out = []
    with torch.no_grad():
        for _ in range(STEPS):
            _, jtobs = jax_obs_norm_step(norm, j_obs, update=False)
            j_action = j_policy(js.actor_params, jtobs).mean
            j_env, jts = jtr.env.step(j_env, j_action)
            j_obs = jts.obs

            _, ttobs = obs_norm_step(t_norm, t_obs, update=False)
            t_action = ttr._policy_dist(ttobs).mean
            t_env, tts = ttr.env.step(t_env, t_action)
            t_obs = tts.obs
            out.append(dict(
                action=(t_action.numpy(), np.asarray(j_action)),
                reward=(tts.reward.numpy(), np.asarray(jts.reward)),
                particles=(t_env.scene.particles.pos.numpy(), np.asarray(j_env.scene.particles.pos)),
            ))
    return out


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("quantity", ["action", "reward"])
def test_rollout_step_matches_reference(rollouts, step, quantity):
    got, ref = rollouts[step][quantity]
    assert close(got, ref), (quantity, np.abs(got - ref).max(), np.abs(ref).max())


def test_final_particles_match_reference(rollouts):
    got, ref = rollouts[-1]["particles"]
    assert close(got, ref), np.abs(got - ref).max()


def test_render_frames_match_reference():
    """`collect_frames` against the JAX `_collect_frames` on cloth_hanging
    (grippers, particles, the hook, task distance) from the same state,
    stopping before env 0's episode end, within 1e-5 of scale (measured:
    particles 8.3e-7 over the two frames)."""
    jtr, js, j_policy, j_step, ttr, t_norm = agents()
    assert_frames_close(*render_frames(jtr, js, j_policy, j_step, ttr, t_norm, cloth_state_from_jax), 1e-5)


def test_rollout_and_eval_run_on_cpu():
    cfg = load_config("cloth_hanging_multi_hepi_trpl", overrides={
        "env": {"num_envs": 2, "kwargs": {"warmup_steps": 1, "episode_length": 3}},
        "collector": {"frames_per_batch": 8}, "algorithm": {"latent_dim": 8, "num_ori": 4},
    })
    trainer = trainer_from_config(cfg, device="cpu")
    with counting("kernels.cloth_solve") as launched:
        state = trainer.init(torch.Generator().manual_seed(0))
        gen_state = state.generator.get_state()
        state, batch, stats = trainer._collect(state)
        assert batch.action.shape == (4, 2, 12) and batch.tobs["scalars"].shape[:2] == (4, 2)
        assert stats["train/episodes"].item() == 2  # one episode end per env in 4 steps of 3
        success = trainer.eval_success(state, 4)
        assert all(torch.isfinite(v) for v in success.values())
        assert torch.isfinite(trainer.eval_rollout(state, 4))
    assert launched == {"kernels.cloth_solve": 0}  # CPU tensors never reach the kernel
    assert trainer.policy.backbone.node_encoder.weight.dtype == torch.float32
    assert trainer.policy.backbone.dtype == torch.bfloat16  # the config's algorithm.dtype
    # eval derives its generator without advancing the state's
    g = torch.Generator().manual_seed(5)
    before = g.get_state()
    assert fold_in(g, 7).initial_seed() != fold_in(g, 13).initial_seed()
    assert torch.equal(g.get_state(), before)
    assert len({s.initial_seed() for s in split_generator(g, 4)}) == 4
    assert not torch.equal(state.generator.get_state(), gen_state)  # collection sampled actions


def test_port_imports_no_jax(tmp_path):
    """The port on the CPU (trainer_from_config -> init -> a 2-step _collect
    -> train_iteration, then the training CLI and play on a tiny cloth run
    with `use_pallas_solver=true`, on a tiny rigid_insertion run, on a tiny
    rope_closing run and on a tiny EMPN cloth run, and the three tools at a
    tiny size) imports neither jax, flax, optax nor the JAX package, nor its
    native library."""
    code = (
        "import sys, json, torch\n"
        "from geometry_rl_torch.config import load_config, trainer_from_config\n"
        "from geometry_rl_torch.train import cli, play\n"
        "cfg = load_config('cloth_hanging_multi_hepi_trpl', overrides={'env': {'num_envs': 2, 'kwargs': "
        "{'warmup_steps': 1}}, 'collector': {'frames_per_batch': 4}, 'algorithm': {'latent_dim': 8, 'num_ori': 4, "
        "'objective': {'mini_batch_size': 2}}})\n"
        "tr = trainer_from_config(cfg, device='cpu')\n"
        "state, batch, _ = tr._collect(tr.init(torch.Generator().manual_seed(0)))\n"
        "assert batch.action.shape == (2, 2, 12)\n"
        "state, metrics = tr.train_iteration(state)\n"
        "assert state.num_updates == 2 * 5 and torch.isfinite(metrics['loss_critic']) and torch.isfinite(metrics['kl'])\n"
        "run = cli.main(['--config', 'cloth_hanging_multi_hepi_trpl', '--device', 'cpu', '--override', "
        "'env.num_envs=2', 'env.kwargs.warmup_steps=1', 'env.kwargs.use_pallas_solver=true', "
        "'collector.frames_per_batch=4', 'collector.total_frames=4', 'algorithm.latent_dim=8', 'algorithm.num_ori=4', "
        f"'algorithm.objective.mini_batch_size=2', 'logger.log_dir={tmp_path}'])\n"
        "play.main(['--run-dir', run, '--checkpoint', 'checkpoints', '--episodes-steps', '2', '--device', 'cpu'])\n"
        "run = cli.main(['--config', 'rigid_insertion_multi_hepi_trpl', '--device', 'cpu', '--override', "
        "'env.num_envs=4', 'env.kwargs.warmup_steps=0', 'env.kwargs.episode_length=8', 'collector.frames_per_batch=16', "
        "'collector.total_frames=16', 'algorithm.latent_dim=8', 'algorithm.num_ori=4', "
        f"'algorithm.objective.mini_batch_size=8', 'logger.log_dir={tmp_path}/rigid'])\n"
        "res = play.main(['--run-dir', run, '--checkpoint', 'checkpoints', '--episodes-steps', '8', "
        "'--success-threshold', '0.1', '--device', 'cpu'])\n"
        "assert 0.0 <= res['0']['success_rate'] <= 1.0\n"
        "from geometry_rl_torch.tools import eval_breakdown, learn_check, smoke_env\n"
        "rep = eval_breakdown.main(['--run-dir', run, '--checkpoint', 'checkpoints', '--episodes', '1', '--device', 'cpu'])\n"
        "assert rep['overall']['episodes'] == 4 and len(rep['per_shape']) == 4\n"
        "smoke_env.main(['--task', 'cloth_hanging', '--num-envs', '2', '--steps', '2', '--device', 'cpu'])\n"
        "hist, summary = learn_check.main(['--task', 'rope_closing', '--num-envs', '2', '--iterations', '1', "
        "'--steps-per-batch', '2', '--mini-batch', '4', '--device', 'cpu'])\n"
        "assert len(hist) == 1 and summary['env_steps'] == 4\n"
        "run = cli.main(['--config', 'rope_closing_hepi_trpl', '--device', 'cpu', '--override', "
        "'env.num_envs=4', 'env.kwargs.num_links=10', 'env.kwargs.rope_length=1.25', 'env.kwargs.episode_length=6', "
        "'collector.frames_per_batch=24', 'collector.total_frames=24', 'algorithm.latent_dim=8', 'algorithm.num_ori=4', "
        f"'algorithm.objective.mini_batch_size=12', 'logger.log_dir={tmp_path}/rope'])\n"
        "res = play.main(['--run-dir', run, '--checkpoint', 'checkpoints', '--episodes-steps', '6', "
        "'--success-threshold', '0.1', '--device', 'cpu'])\n"
        "assert 0.0 <= res['0']['success_rate'] <= 1.0\n"
        "run = cli.main(['--config', 'cloth_hanging_multi_empn_trpl', '--device', 'cpu', '--override', "
        "'env.num_envs=2', 'env.kwargs.warmup_steps=1', 'collector.frames_per_batch=4', 'collector.total_frames=4', "
        f"'algorithm.latent_dim=8', 'algorithm.num_ori=4', 'algorithm.objective.mini_batch_size=2', 'logger.log_dir={tmp_path}/empn'])\n"
        "res = play.main(['--run-dir', run, '--checkpoint', 'checkpoints', '--episodes-steps', '2', '--device', 'cpu'])\n"
        "from geometry_rl_torch import models\n"
        "empn = trainer_from_config(load_config('cloth_hanging_multi_empn_trpl', overrides={'env': {'num_envs': 2}}), device='cpu')\n"
        "assert type(empn.policy.backbone) is models.PonitaGCN\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', 'geometry_rl_tpu'))))\n"
    )
    env = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"}, **test_torch_common.SUBPROCESS_THREADS}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
