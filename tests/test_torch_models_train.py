"""Training paths of the models and tasks beyond the three HEPi main paths,
against the JAX package: EMPN and the Transformer on rigid_insertion and
cloth_hanging, and HEPi on the two-gripper task (the only rigid graph with an
`agent` conv; with its YAML's std floor and cap and gradient clip) and on
rigid_sliding (its YAML's entropy coefficient and projection bounds).

Both packages build the agent with `build_agent(task, model, ...)` at a small
size in f32. The JAX agent collects 3 steps and runs one `_update`; the port
takes its params, normaliser and env state, and
- replays the 3 collect steps with the JAX agent's sampled actions: the
  normalised observation, the policy's mean and std, the value and the reward
  of every step against the JAX batch (its own env state and normaliser
  running free);
- runs `_update` from the JAX batch with the JAX permutations substituted.

Tolerances are those of tests/test_torch_rigid_slice.py: the rollout within
1e-4 of each quantity's scale; params after the update within 1e-6 per Adam
step taken; aggregated metrics within 1e-4 relative and 1e-5 absolute.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from geometry_rl_torch import convert
from geometry_rl_torch.config import load_config, trainer_from_config
from geometry_rl_torch.rl.obs_pipeline import obs_norm_step
from geometry_rl_torch.train import TrainConfig
from geometry_rl_torch.train.builders import build_agent
from geometry_rl_torch.utils.trace import counting
from test_torch_common import close, frozen, np_tree, port_agent, reference_agent

STEPS, RTOL = 3, 1e-4
CFG = dict(steps_per_batch=STEPS, mini_batch_size=6, ppo_epochs=2, total_iterations=10)
SMALL = dict(num_envs=4, latent_dim=8, num_ori=4)  # the sizes of tests/test_torch_rigid_slice.py
CLOTH = dict(warmup_steps=0, use_pallas_solver=False)  # the XPBD solver in both packages: it jits on the CPU
RIGID = dict(warmup_steps=0)
# id: (task, model, env kwargs, build_agent keywords, TrainConfig fields)
COMBOS = {
    "rigid_insertion-empn": ("rigid_insertion", "empn", RIGID, {}, {}),
    "rigid_insertion-transformer": ("rigid_insertion", "transformer", RIGID, {}, {}),
    "cloth_hanging-empn": ("cloth_hanging", "empn", CLOTH, dict(trust_region_coeff=4.0, cov_bound=1e-3), {}),
    "cloth_hanging-transformer": ("cloth_hanging", "transformer", CLOTH, dict(trust_region_coeff=4.0, cov_bound=1e-3), {}),
    "rigid_insertion_two_agents-hepi": ("rigid_insertion_two_agents", "hepi", RIGID, dict(minimal_std=0.05, max_std=1.2),
                                        dict(clip_grad_norm=True, max_grad_norm=1.0)),
    "rigid_sliding-hepi": ("rigid_sliding", "hepi", RIGID, dict(trust_region_coeff=4.0, cov_bound=1e-3),
                           dict(entropy_coef=0.0005)),
}


@functools.lru_cache(maxsize=None)
def run(combo):
    task, model, env_kw, agent_kw, train_kw = COMBOS[combo]
    akw, tkw = frozen(env_kwargs=env_kw, **SMALL, **agent_kw), frozen(**CFG, **train_kw)
    jtr, js0 = reference_agent(task, model, akw, tkw, seed=2)
    js1, jbatch, _ = jax.jit(jtr._collect)(js0)
    js2, jm = jax.jit(jtr._update)(js1, jbatch)
    jb = np_tree(jbatch)

    # the collect, replayed with the JAX agent's actions
    ttr, state = port_agent(task, model, js0, akw, tkw)
    from_jax = convert.cloth_state_from_jax if task == "cloth_hanging" else convert.rigid_state_from_jax
    env_state = from_jax(np_tree(js0.env_state), torch.Generator().manual_seed(0))
    norm, obs, rollout = state.norm, ttr.env.observe(env_state), []
    with torch.no_grad():
        for t in range(STEPS):
            norm, tobs = obs_norm_step(norm, obs, update=True)
            dist, value = ttr._policy_dist(tobs), ttr._value(tobs)
            env_state, ts = ttr.env.step(env_state, torch.as_tensor(np.array(jb.action[t])))
            obs = ts.obs
            rollout.append({
                "tobs": (torch.cat([tobs[k].reshape(tobs[k].shape[0], -1) for k in sorted(tobs)], -1).numpy(),
                         np.concatenate([jb.tobs[k][t].reshape(jb.tobs[k].shape[1], -1) for k in sorted(jb.tobs)], -1)),
                "mean": (dist.mean.numpy(), jb.mean[t]), "std": (dist.std.numpy(), jb.std[t]),
                "value": (value.numpy(), jb.value[t]), "reward": (ts.reward.numpy(), jb.reward[t]),
            })

    # the update, from the JAX batch and permutations
    state = state._replace(norm=convert.obs_norm_from_jax(np_tree(js1.norm)),
                           obs={k: torch.as_tensor(np.array(v)) for k, v in js1.obs.items()})
    key, perms = js1.key, []
    n, n_mb, mb = STEPS * SMALL["num_envs"], jtr.num_minibatches, jtr.mini_batch_size
    for _ in range(CFG["ppo_epochs"]):
        key, k_perm = jax.random.split(key)
        perms.append(torch.as_tensor(np.array(jax.random.permutation(k_perm, n)[: n_mb * mb].reshape(n_mb, mb))))
    perm_iter = iter(perms)
    ttr._permutation = lambda generator, n: next(perm_iter)
    state, tm = ttr._update(state, convert.batch_from_jax(jb))
    return ttr, state, tm, np_tree(js2), jm, rollout


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("combo", list(COMBOS))
def test_collect_step_matches_reference(combo, step):
    row = run(combo)[5][step]
    if step == 0:
        assert np.abs(row["mean"][1]).max() > 1e-3  # a non-trivial policy output
    for quantity, (got, ref) in row.items():
        assert close(got, ref, RTOL), (quantity, np.abs(got - ref).max(), np.abs(ref).max())


@pytest.mark.parametrize("part", ["policy", "critic"])
@pytest.mark.parametrize("combo", list(COMBOS))
def test_update_params_match_reference(combo, part):
    ttr, state, _, js2, _, _ = run(combo)
    steps = CFG["ppo_epochs"] * 2
    assert state.num_updates == int(js2.num_updates) == steps
    ref = convert.params_from_flax(getattr(js2, "actor_params" if part == "policy" else "critic_params"))
    got = getattr(ttr, part).state_dict()
    assert sorted(got) == sorted(ref)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), atol=steps * 1e-6, rtol=0, err_msg=f"{part}.{k}")


@pytest.mark.parametrize("combo", list(COMBOS))
def test_update_metrics_match_reference(combo):
    ttr, _, tm, _, jm, _ = run(combo)
    assert sorted(tm) == sorted(jm)
    for k, v in jm.items():
        np.testing.assert_allclose(tm[k].item(), float(v), rtol=1e-4, atol=1e-5, err_msg=k)
    if combo == "rigid_insertion_two_agents-hepi":
        # that YAML's head and optimizer settings were in force
        assert ttr.cfg.clip_grad_norm and ttr.policy.minimal_std == 0.05 and ttr.policy_builder.graph_levels[1] == "agent"
        assert "processor_1_agent.kernel.weight" in "".join(ttr.policy.backbone.state_dict())
        assert 0.05 < tm["policy_std_min"].item() and tm["policy_std"].item() < 1.2


@pytest.mark.parametrize("task,model", [("rigid_sliding", "hepi"), ("rigid_insertion_two_agents", "hepi"), ("rope_shaping", "hepi"),
                                        ("rigid_insertion", "empn"), ("rigid_insertion", "gcn"), ("rigid_insertion", "meshgraphnet"),
                                        ("rigid_pushing", "mlp"), ("cloth_hanging", "mlp"), ("cloth_hanging", "transformer")])
def test_all_tasks_and_models_train(task, model):
    """Every registered task x a spread of models completes a TRPL iteration
    on the CPU: finite metrics, params moved."""
    kwargs = {"episode_length": 4}
    if task.startswith("rigid"):
        kwargs["warmup_steps"] = 0
    if task == "rope_shaping":
        kwargs.update({"num_links": 10, "rope_length": 1.25})
    t = build_agent(task=task, model=model, num_envs=2, latent_dim=16, num_ori=4, device="cpu", env_kwargs=kwargs,
                    train_cfg=TrainConfig(steps_per_batch=4, ppo_epochs=1, mini_batch_size=8), training_noise=model == "mlp")
    state = t.init(torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in t.policy.state_dict().items()}
    state, metrics = t.train_iteration(state)
    assert state.num_updates == 1
    assert all(torch.isfinite(v).all() for v in metrics.values()), (task, model, metrics)
    assert any((t.policy.state_dict()[k] - v).abs().max() > 0 for k, v in before.items())


@pytest.mark.parametrize("model", ["hepi", "transformer", "gcn"])
def test_concat_global_agents_train(model):
    """`build_agent(..., concat_global=True)`: the heads read the doubled latent."""
    t = build_agent("rigid_insertion", model, num_envs=2, latent_dim=8, num_ori=4, device="cpu", concat_global=True,
                    env_kwargs={"warmup_steps": 0, "episode_length": 4},
                    train_cfg=TrainConfig(steps_per_batch=4, ppo_epochs=1, mini_batch_size=8))
    assert t.policy.pre_std.in_features == 16
    state, metrics = t.train_iteration(t.init(torch.Generator().manual_seed(0)))
    assert state.num_updates == 1 and all(torch.isfinite(v).all() for v in metrics.values())


@pytest.mark.parametrize("name", ["cloth_hanging_multi_empn_trpl", "rigid_insertion_multi_transformer_trpl",
                                  "rigid_insertion_two_agents_multi_hepi_trpl", "rigid_pushing_multi_empn_trpl"])
def test_train_iteration_runs_on_cpu(name):
    """trainer_from_config -> init -> train_iteration of a shared YAML in its
    own dtype (bf16 activations) at a tiny size."""
    cfg = load_config(name, overrides={
        "env": {"num_envs": 2, "kwargs": {"warmup_steps": 1, "episode_length": 3}},
        "collector": {"frames_per_batch": 8}, "algorithm": {"latent_dim": 8, "num_ori": 4, "objective": {"mini_batch_size": 4}},
    })
    trainer = trainer_from_config(cfg, device="cpu")
    with counting("kernels.cloth_solve", "kernels.cloth_solve_env") as launched:
        state = trainer.init(torch.Generator().manual_seed(0))
        state, metrics = trainer.train_iteration(state)
    assert state.num_updates == 5 * 2
    assert all(torch.isfinite(v).all() for v in metrics.values()), metrics
    assert metrics["train/episodes"].item() == 2  # one episode end per env in 4 steps of 3
    assert launched == {"kernels.cloth_solve": 0, "kernels.cloth_solve_env": 0}  # CPU tensors take the plain version
