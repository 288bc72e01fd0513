"""The TRPL update and the train/play CLIs of the PyTorch port.

Both packages build the cloth_hanging HEPi agent at a small size in f32. The
JAX agent collects one batch; the port takes its params (`params_from_flax`),
normaliser, last observation and batch (`batch_from_jax`), and both update
from there.

Tolerances:
- GAE inputs of the update (advantage, value targets): 1e-5 absolute, the
  bootstrap value is one critic forward (~1e-6 relative, tests/test_torch_hepi.py).
- Loss and metrics of a minibatch: 1e-5 relative, 1e-5 absolute (with
  normalised advantages `loss_objective` is a mean of unit terms that cancels
  to ~1e-8, where the two sums' rounding, ~1e-6, is all that is left).
- Gradients: within 1e-4 of each tensor's largest entry. HEPi's backward
  sums messages in another order than XLA; the largest entries are ~1e1.
- Params after Adam steps: 1e-6 absolute per step taken. Adam moves each
  entry by at most ~lr = 3e-4 per step, normalised by the gradient's own
  scale, so a 1e-4 relative gradient gap moves a param by ~3e-8.
- Metrics aggregated over a whole update: 1e-4 relative, 1e-5 absolute. After the first
  step the params differ by ~1e-7, and the constraint metrics (divergences
  between nearby distributions, ~3e-2) move 5e-5 relative with them.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import test_torch_common  # noqa: F401  (pins torch to one thread per test worker)

from geometry_rl_tpu.rl.gae import gae as jax_gae
from geometry_rl_tpu.rl.obs_pipeline import obs_norm_step as jax_obs_norm_step
from geometry_rl_tpu.train import TrainConfig as JaxTrainConfig
from geometry_rl_tpu.train.builders import build_agent as jax_build_agent
from geometry_rl_torch.convert import batch_from_jax, obs_norm_from_jax, params_from_flax
from geometry_rl_torch.train import TrainConfig
from geometry_rl_torch.train.builders import build_agent
from geometry_rl_torch.train.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from geometry_rl_torch.utils.trace import counting

SMALL = dict(num_envs=2, latent_dim=8, num_ori=4, trust_region_coeff=4.0, cov_bound=1e-3)
CFG = dict(steps_per_batch=4, mini_batch_size=4, ppo_epochs=2, total_iterations=10)


def np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module")
def ref():
    jtr = jax_build_agent("cloth_hanging", "hepi", train_cfg=JaxTrainConfig(**CFG),
                          env_kwargs=dict(warmup_steps=0, use_pallas_solver=False), **SMALL)
    js = jax.jit(jtr.init)(jax.random.PRNGKey(1))  # jitted: 4x faster than op by op on the CPU
    js, jbatch, _ = jax.jit(jtr._collect)(js)
    ttr = build_agent("cloth_hanging", "hepi", train_cfg=TrainConfig(**CFG), env_kwargs=dict(warmup_steps=0), device="cpu",
                      **SMALL)
    return jtr, js, jbatch, ttr


def port_state(jtr, js, ttr):
    """The port's TrainState and params as the JAX state holds them, with
    fresh Adam states."""
    state = ttr.init(torch.Generator().manual_seed(0))
    ttr.policy.load_state_dict(params_from_flax(np_tree(js.actor_params)))
    ttr.critic.load_state_dict(params_from_flax(np_tree(js.critic_params)))
    return state._replace(
        norm=obs_norm_from_jax(np_tree(js.norm)),
        obs={k: torch.as_tensor(np.array(v)) for k, v in js.obs.items()},
        initial_entropy=torch.as_tensor(np.array(js.initial_entropy)),
    )


def flat_grads(module):
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p)).clone() for n, p in module.named_parameters()}


def assert_grads_close(got, ref_tree, what):
    ref = params_from_flax(np_tree(ref_tree))
    assert sorted(got) == sorted(ref), what
    for k, r in ref.items():
        scale = max(r.abs().max().item(), 1e-6)
        assert (got[k] - r).abs().max().item() <= 1e-4 * scale, (what, k, (got[k] - r).abs().max().item(), scale)


def assert_params_close(module, ref_tree, atol, what):
    ref = params_from_flax(np_tree(ref_tree))
    for k, v in module.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), atol=atol, rtol=0, err_msg=f"{what}.{k}")


def test_update_data_matches_reference(ref):
    """GAE with the critic's bootstrap on the post-rollout observation, and
    the [T, B] -> [T*B] flattening with env ids tiled over time."""
    jtr, js, jbatch, ttr = ref
    state = port_state(jtr, js, ttr)
    data = ttr._update_data(state, batch_from_jax(np_tree(jbatch)))
    _, final_tobs = jax_obs_norm_step(js.norm, js.obs, update=False)
    boot = jax.jit(jtr._value)(js.critic_params, final_tobs)
    adv, vt = jax_gae(jbatch.reward, jbatch.value, jbatch.done.astype(jnp.float32), boot, 0.99, 0.95)
    np.testing.assert_allclose(data["advantage"].numpy(), np.asarray(adv).reshape(-1), atol=1e-5)
    np.testing.assert_allclose(data["value_target"].numpy(), np.asarray(vt).reshape(-1), atol=1e-5)
    np.testing.assert_array_equal(data["env_ids"].numpy(), np.tile(np.arange(2), 4))
    np.testing.assert_array_equal(data["tobs"]["scalars"].numpy(), np.asarray(jbatch.tobs["scalars"]).reshape(8, -1))


def test_minibatch_step_matches_reference(ref):
    """Loss, metrics and gradients of one minibatch, and the params after one
    Adam step (optax adam, eps 1e-5)."""
    jtr, js, jbatch, ttr = ref
    state = port_state(jtr, js, ttr)
    data = ttr._update_data(state, batch_from_jax(np_tree(jbatch)))
    idx = torch.tensor([5, 0, 7, 2])
    mb = {k: ({g: x[idx] for g, x in v.items()} if k == "tobs" else v[idx]) for k, v in data.items()}
    mb_j = jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()), mb)

    (jloss, (jm, _)), (ga, gc) = jax.jit(jax.value_and_grad(jtr._minibatch_loss, argnums=(0, 1), has_aux=True))(
        js.actor_params, js.critic_params, mb_j, jnp.int32(0), js.initial_entropy
    )
    tloss, _ = ttr._minibatch_loss(mb, 0, state.initial_entropy)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    tm, kl_beta = ttr._minibatch_step(state, mb, 0)
    assert kl_beta is None  # TRPL carries no KL-penalty coefficient
    assert set(jm) | {"grad_norm_actor", "grad_norm_actor_max"} == set(tm)
    for k, v in jm.items():
        np.testing.assert_allclose(tm[k].item(), float(v), rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(tm["grad_norm_actor"].item(), float(optax.global_norm(ga)), rtol=1e-4)
    assert_grads_close(flat_grads(ttr.policy), ga, "actor")
    assert_grads_close(flat_grads(ttr.critic), gc, "critic")

    a_up, _ = jtr.actor_tx.update(ga, js.actor_opt, js.actor_params)
    c_up, _ = jtr.critic_tx.update(gc, js.critic_opt, js.critic_params)
    assert_params_close(ttr.policy, optax.apply_updates(js.actor_params, a_up), 1e-6, "actor")
    assert_params_close(ttr.critic, optax.apply_updates(js.critic_params, c_up), 1e-6, "critic")


def test_update_matches_reference(ref, monkeypatch):
    """A whole `_update` (2 epochs x 2 minibatches) with the JAX permutations
    substituted: params after it, and the aggregated metrics."""
    jtr, js, jbatch, ttr = ref
    state = port_state(jtr, js, ttr)
    js_new, jm = jax.jit(jtr._update)(js, jbatch)

    key, perms = js.key, []
    n_mb, mb = jtr.num_minibatches, jtr.mini_batch_size
    for _ in range(CFG["ppo_epochs"]):
        key, k_perm = jax.random.split(key)
        perms.append(torch.as_tensor(np.asarray(jax.random.permutation(k_perm, 8)[: n_mb * mb].reshape(n_mb, mb))))
    perm_iter = iter(perms)
    monkeypatch.setattr(ttr, "_permutation", lambda generator, n: next(perm_iter))

    state, tm = ttr._update(state, batch_from_jax(np_tree(jbatch)))
    assert state.num_updates == int(js_new.num_updates) == 4
    steps = CFG["ppo_epochs"] * n_mb
    assert_params_close(ttr.policy, js_new.actor_params, steps * 1e-6, "actor")
    assert_params_close(ttr.critic, js_new.critic_params, steps * 1e-6, "critic")
    assert sorted(tm) == sorted(jm)
    for k, v in jm.items():
        np.testing.assert_allclose(tm[k].item(), float(v), rtol=1e-4, atol=1e-5, err_msg=k)


def test_update_moves_params_and_counts_updates(ref):
    """The port's own permutation path: every sample trains once per epoch
    and the lr anneal and grad clip engage."""
    jtr, js, jbatch, ttr = ref
    import dataclasses

    ttr.cfg = dataclasses.replace(ttr.cfg, anneal_lr=True, clip_grad_norm=True, max_grad_norm=0.5)
    try:
        state = port_state(jtr, js, ttr)
        before = {k: v.clone() for k, v in ttr.policy.state_dict().items()}
        perm = ttr._permutation(torch.Generator().manual_seed(3), 8)
        assert sorted(perm.reshape(-1).tolist()) == list(range(8))
        state, metrics = ttr._update(state, batch_from_jax(np_tree(jbatch)))
        assert state.num_updates == 4
        assert all(torch.isfinite(v) for v in metrics.values())
        assert any((ttr.policy.state_dict()[k] - v).abs().max() > 0 for k, v in before.items())
        assert state.actor_opt.param_groups[0]["lr"] == pytest.approx(3e-4 * (1 - 3 / ttr.total_network_updates))
        grads = [p.grad for p in ttr.policy.parameters() if p.grad is not None]
        assert torch.sqrt(sum((g**2).sum() for g in grads)) <= 0.5 + 1e-6  # clipped before Adam
    finally:
        ttr.cfg = dataclasses.replace(ttr.cfg, anneal_lr=False, clip_grad_norm=False, max_grad_norm=1.0)


# ------------------------------------------------------- the training noise
# The two packages draw from different generators, so the noise itself cannot
# match; these tests hold its law and its placement to the reference's.
NOISE_STD = 0.05
NOISE_DRAWS = 16  # 16 draws x 8 samples: >= 4,600 values per node type
NOISE_STD_RTOL = 0.05  # the sample std of >= 4,600 normals is within ~1% (1 sigma)


@pytest.fixture(scope="module")
def noisy():
    return build_agent("cloth_hanging", "hepi", train_cfg=TrainConfig(**CFG), env_kwargs=dict(warmup_steps=0),
                       training_noise=True, training_noise_std=NOISE_STD, device="cpu", **SMALL)


def flat_tobs(jbatch):
    return {k: np.array(v).reshape((-1,) + v.shape[2:]) for k, v in jbatch.tobs.items()}


@pytest.mark.parametrize("part", ["policy", "critic"])
def test_training_noise_has_the_reference_law(ref, noisy, part):
    """Per node type, the noise the builder adds to the vector features is
    zero-mean with std `training_noise_std`, in the port and in the
    reference's builder alike; scalars and the graph stay clean."""
    import dataclasses

    jtr, _, jbatch, _ = ref
    tobs_np = flat_tobs(jbatch)
    env_ids = np.tile(np.arange(SMALL["num_envs"]), CFG["steps_per_batch"])
    jb = dataclasses.replace(getattr(jtr, f"{part}_builder"), training_noise=True, training_noise_std=NOISE_STD)
    tobs_j = {k: jnp.asarray(v) for k, v in tobs_np.items()}
    build_j = jax.jit(lambda key: jb.build(tobs_j, jnp.asarray(env_ids), noise_key=key)[1].vectors)
    clean_j = jb.build(tobs_j, jnp.asarray(env_ids))[1].vectors
    tb = getattr(noisy, f"{part}_builder")
    tobs_t = {k: torch.as_tensor(v) for k, v in tobs_np.items()}
    graph_c, clean_t = tb.build(tobs_t, torch.as_tensor(env_ids))
    gen = torch.Generator().manual_seed(5)
    diffs_j = {nt: [] for nt in clean_j}
    diffs_t = {nt: [] for nt in clean_j}
    for d in range(NOISE_DRAWS):
        vj = build_j(jax.random.PRNGKey(d))
        graph_n, feats = tb.build(tobs_t, torch.as_tensor(env_ids), gen)
        assert all(torch.equal(feats.scalars[nt], clean_t.scalars[nt]) for nt in clean_t.scalars)
        assert all(torch.equal(graph_n.nodes[nt].pos, graph_c.nodes[nt].pos) for nt in graph_c.nodes)
        for nt in clean_j:
            diffs_j[nt].append(np.asarray(vj[nt] - clean_j[nt]).reshape(-1))
            diffs_t[nt].append((feats.vectors[nt] - clean_t.vectors[nt]).reshape(-1).numpy())
    assert sorted(clean_t.vectors) == sorted(clean_j)
    for nt in clean_j:
        dj, dt = np.concatenate(diffs_j[nt]), np.concatenate(diffs_t[nt])
        assert dt.size == dj.size >= 4600, (nt, dt.size)
        for what, d in (("port", dt), ("reference", dj)):
            assert abs(d.std() / NOISE_STD - 1.0) <= NOISE_STD_RTOL, (what, nt, d.std())
            assert abs(d.mean()) <= 4 * NOISE_STD / np.sqrt(d.size), (what, nt, d.mean())


def test_training_noise_acts_on_update_forwards_only(ref, noisy):
    """Collect forwards stay clean (the batch equals the noise-off agent's);
    update forwards draw noise that is fresh per network update and the
    same for the same `num_updates`."""
    jtr, js, jbatch, ttr = ref
    s_clean, s_noisy = port_state(jtr, js, ttr), port_state(jtr, js, noisy)
    _, b_clean, _ = ttr._collect(s_clean)
    _, b_noisy, _ = noisy._collect(s_noisy)
    for f in b_clean._fields:
        a, b = getattr(b_clean, f), getattr(b_noisy, f)
        assert (all(torch.equal(a[k], b[k]) for k in a) if f == "tobs" else torch.equal(a, b)), f

    data = ttr._update_data(s_clean, batch_from_jax(np_tree(jbatch)))
    idx = torch.tensor([5, 0, 7, 2])
    mb = {k: ({g: x[idx] for g, x in v.items()} if k == "tobs" else v[idx]) for k, v in data.items()}
    ie = s_clean.initial_entropy
    with torch.no_grad():
        clean = ttr._minibatch_loss(mb, 3, ie)[0].item()
        first = noisy._minibatch_loss(mb, 3, ie)[0].item()
        again = noisy._minibatch_loss(mb, 3, ie)[0].item()
        other = noisy._minibatch_loss(mb, 4, ie)[0].item()
    assert first == again  # reproducible per num_updates
    assert first != clean and other != first  # noise on, fresh per update


def test_checkpoint_round_trip_is_exact(ref, tmp_path):
    jtr, js, jbatch, ttr = ref
    state = port_state(jtr, js, ttr)
    state, _ = ttr._update(state, batch_from_jax(np_tree(jbatch)))
    for step in range(7):
        save_checkpoint(str(tmp_path), step, ttr, state, max_to_keep=3)
    assert sorted(os.listdir(tmp_path)) == ["4", "5", "6"] and latest_step(str(tmp_path)) == 6
    params = {k: v.clone() for k, v in ttr.policy.state_dict().items()}
    fresh = ttr.init(torch.Generator().manual_seed(9))  # new params, Adam states, env state
    restored = restore_checkpoint(str(tmp_path), ttr, fresh)
    assert all(torch.equal(ttr.policy.state_dict()[k], v) for k, v in params.items())
    assert restored.num_updates == state.num_updates
    assert torch.equal(restored.generator.get_state(), state.generator.get_state())
    assert torch.equal(restored.env_state.generator.get_state(), state.env_state.generator.get_state())
    assert torch.equal(restored.env_state.scene.particles.pos, state.env_state.scene.particles.pos)
    a, b = restored.actor_opt.state_dict(), state.actor_opt.state_dict()
    assert a["param_groups"] == b["param_groups"]
    for i, s in b["state"].items():
        assert all(torch.equal(a["state"][i][k], v) for k, v in s.items())


# ---------------------------------------------------------------- the CLIs

TINY = [
    "env.num_envs=2", "env.kwargs.warmup_steps=1", "env.kwargs.episode_length=3", "env.kwargs.use_pallas_solver=true",
    "collector.frames_per_batch=8", "collector.total_frames=24", "algorithm.latent_dim=8", "algorithm.num_ori=4",
    "algorithm.objective.mini_batch_size=4", "logger.checkpoint.save_interval=1",
]


def train(log_dir, *args):
    from geometry_rl_torch.train import cli

    run = cli.main(["--config", "cloth_hanging_multi_hepi_trpl", "--device", "cpu", *args,
                    "--override", *TINY, f"logger.log_dir={log_dir}"])
    return run, [json.loads(line) for line in open(os.path.join(run, "metrics.jsonl"))]


def test_train_cli_logs_checkpoints_and_resumes_exactly(ref, tmp_path):
    jtr, js, jbatch, _ = ref
    _, jm = jax.jit(jtr._update)(js, jbatch)
    with counting("kernels.cloth_solve", "kernels.cloth_solve_env") as launched:
        run, rows = train(tmp_path / "a")
    assert launched == {"kernels.cloth_solve": 0, "kernels.cloth_solve_env": 0}  # CPU tensors take the plain version
    assert len(rows) == 3 and [r["step"] for r in rows] == [0, 1, 2]
    reference_keys = set(jm) | {"train/reward", "train/episodes", "train/iteration_time", "train/frames"}
    for r in rows:
        assert reference_keys <= set(r), reference_keys - set(r)
        assert all(np.isfinite(v) for v in r.values())
    hp = json.load(open(os.path.join(run, "hparams.json")))
    assert hp["env"]["kwargs"]["use_pallas_solver"] is True and hp["algorithm"]["projection"]["cov_bound"] == 1e-3
    assert sorted(os.listdir(os.path.join(run, "checkpoints"))) == ["0", "1", "2"]
    assert os.listdir(os.path.join(run, "best"))

    # resume from iteration 1's checkpoint: iteration 2 reproduces exactly
    resume_dir = tmp_path / "from1"
    shutil.copytree(os.path.join(run, "checkpoints", "1"), resume_dir / "1")
    run_b, rows_b = train(tmp_path / "b", "--resume", str(resume_dir))
    assert [r["step"] for r in rows_b] == [2]
    timing = {"wall_time", "train/iteration_time", "train/collect_time", "train/update_time"}
    assert {k: v for k, v in rows_b[0].items() if k not in timing} == {k: v for k, v in rows[2].items() if k not in timing}
    a = torch.load(os.path.join(run, "checkpoints", "2", "state.pt"), weights_only=True)
    b = torch.load(os.path.join(run_b, "checkpoints", "2", "state.pt"), weights_only=True)
    for part in ("policy", "critic"):
        assert all(torch.equal(a[part][k], b[part][k]) for k in a[part])

    from geometry_rl_torch.train import play

    results = play.main(["--run-dir", run, "--checkpoint", "checkpoints", "--episodes-steps", "4",
                         "--success-threshold", "0.1", "--device", "cpu"])
    assert json.load(open(os.path.join(run, "eval.json"))) == results
    assert sorted(results) == ["0", "1", "2"]
    for entry in results.values():
        assert np.isfinite(entry["reward"]) and 0.0 <= entry["success_rate"] <= 1.0
    sweep = play.main(["--run-dir", run, "--all-checkpoints", "--episodes-steps", "4", "--num-envs", "3", "--device", "cpu"])
    assert any(k.startswith("best/") for k in sweep) and "2" in sweep


def test_clis_refuse_what_is_not_ported(tmp_path):
    """What the CLIs once refused now runs: `parallel.data_parallel=true` on
    one device trains in one process (the JAX CLI's rule), `env.video` records
    a GIF of the current policy, and `play --record` writes one per
    checkpoint. PAPI steps on the HEPi policy raise the reference's error (no
    Dense `mean` head, a contextual std), and clipped PPO trains."""
    from geometry_rl_torch.train import cli, play

    base = ["--config", "cloth_hanging_multi_hepi_trpl", "--device", "cpu", "--override", *TINY,
            f"logger.log_dir={tmp_path}"]
    run = cli.main(base + ["parallel.data_parallel=true", "collector.total_frames=8", "env.video=true",
                           "env.video_interval=1", "env.video_length=2"])
    assert os.listdir(os.path.join(run, "videos")) == ["iter_00000.gif"]
    # the JAX CLI's rules for splitting the env axis over n devices
    assert cli.data_parallel_width({"env": {"num_envs": 4}}, 2, False) == 2
    assert cli.data_parallel_width({"env": {"num_envs": 4}, "parallel": {"data_parallel": False}}, 2, False) == 1
    assert cli.data_parallel_width({"env": {"num_envs": 3}}, 2, False) == 1  # "auto" and indivisible: one device
    with pytest.raises(ValueError, match="does not divide"):
        cli.data_parallel_width({"env": {"num_envs": 3}, "parallel": {"data_parallel": True}}, 2, False)
    with pytest.raises(ValueError, match="multi-process launch"):
        cli.data_parallel_width({"env": {"num_envs": 3}}, 2, True)
    assert cli.data_parallel_width({"env": {"num_envs": 3}}, 1, True) == 1  # a launch of one process
    with pytest.raises(ValueError, match="non-contextual std"):
        cli.main(base + ["algorithm.objective.papi_steps=true"])
    run = cli.main(base + ["algo=ppo", "collector.total_frames=8"])
    rows = [json.loads(line) for line in open(os.path.join(run, "metrics.jsonl"))]
    assert len(rows) == 1 and "clip_fraction" in rows[0] and "loss_trust_region" not in rows[0]
    assert all(np.isfinite(v) for v in rows[0].values())
    results = play.main(["--run-dir", run, "--checkpoint", "checkpoints", "--episodes-steps", "2",
                         "--record", str(tmp_path / "v"), "--device", "cpu"])
    assert results["0"]["video"] == str(tmp_path / "v" / "0.gif") and os.path.getsize(results["0"]["video"]) > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            cli.main(["--config", "cloth_hanging_multi_hepi_trpl"])


# ------------------------------------------------- behaviour cloning, runner

BC_TOL = 4e-6  # params after 4 Adam steps (eps 1e-8), each moving an entry by at most ~lr = 3e-4


def jax_dataset(jbatch):
    """The JAX batch as a BC dataset in `generate_data`'s layout."""
    T, B = np.asarray(jbatch.action).shape[:2]
    data = {f"obs_{k}": np.asarray(v).reshape((T * B,) + v.shape[2:]) for k, v in jbatch.tobs.items()}
    data["action"] = np.asarray(jbatch.action).reshape(T * B, -1)
    data["env_ids"] = np.tile(np.arange(B, dtype=np.int32), T)
    return data


def test_behavior_cloning_matches_reference(ref):
    """Two epochs of `behavior_cloning` (minibatches of 4 from numpy's
    permutation of the 8 recorded samples, Adam with optax's default eps) in
    both packages from the same params and dataset."""
    from geometry_rl_tpu.train.bc import behavior_cloning as jax_bc
    from geometry_rl_torch.train.bc import behavior_cloning

    jtr, js, jbatch, ttr = ref
    data = jax_dataset(jbatch)
    js_new, jhist = jax_bc(jtr, js, data, epochs=2, batch_size=4, lr=3e-4, eval_steps=0, seed=3)
    state = port_state(jtr, js, ttr)
    state, hist = behavior_cloning(ttr, state, data, epochs=2, batch_size=4, lr=3e-4, eval_steps=0, seed=3)
    assert [h["epoch"] for h in hist] == [0, 1] and set(hist[0]) == set(jhist[0]) == {"epoch", "bc_loss"}
    for h, jh in zip(hist, jhist):
        np.testing.assert_allclose(h["bc_loss"], jh["bc_loss"], rtol=1e-5)
    assert hist[1]["bc_loss"] < hist[0]["bc_loss"]
    assert_params_close(ttr.policy, js_new.actor_params, BC_TOL, "actor")


def test_bc_cli_clones_a_jax_dataset_and_writes_the_jax_layout(ref, tmp_path):
    """A dataset recorded by the JAX package's `generate_data` clones through
    the port's `bc_cli`; the port's own recording has the JAX keys, dtypes
    and shapes; `play` evaluates the clone."""
    from geometry_rl_tpu.train.bc import generate_data as jax_generate_data
    from geometry_rl_torch.train import bc_cli, play

    jtr, js, _, _ = ref
    jax_path = str(tmp_path / "jax" / "data.npz")
    jdata = jax_generate_data(jtr, js, n_steps=2, path=jax_path)
    common = ["--config", "cloth_hanging_multi_hepi_trpl", "--device", "cpu", "--epochs", "1", "--batch-size", "2",
              "--eval-every", "1", "--eval-steps", "3", "--override", *TINY]
    hist = bc_cli.main(common + ["--data", jax_path, "--out-dir", str(tmp_path / "a")])
    assert np.isfinite(hist[0]["bc_loss"]) and np.isfinite(hist[0]["eval_reward"])
    assert not os.path.exists(tmp_path / "a" / "data.npz")

    out = tmp_path / "b"
    hist = bc_cli.main(common + ["--record-steps", "2", "--success-threshold", "0.1", "--fresh-actor", "--out-dir", str(out)])
    assert 0.0 <= hist[-1]["final_eval"]["success_rate"] <= 1.0 and hist[-1]["final_eval"]["transitions"] == 4
    port = np.load(out / "data.npz")
    assert sorted(port.files) == sorted(jdata)
    for k, v in jdata.items():
        assert port[k].shape == v.shape and port[k].dtype == v.dtype, k
    np.testing.assert_array_equal(port["env_ids"], np.tile(np.arange(2, dtype=np.int32), 2))
    assert json.load(open(out / "bc_history.json")) == hist
    results = play.main(["--run-dir", str(out), "--checkpoint", "cloned", "--episodes-steps", "3", "--device", "cpu"])
    assert list(results) == ["cloned/1"] and np.isfinite(results["cloned/1"]["reward"])


def test_runner_matches_reference_and_round_trips(ref, tmp_path):
    """`OnPolicyRunner.get_inference_policy` against the JAX runner's on the
    same params, normaliser and observation (1e-5 relative to the mean's
    scale, tests/test_torch_hepi.py's forward tolerance); `learn(2)` logs two
    rows; `save` then `load` restores bit-exactly."""
    from geometry_rl_tpu.train.runner import OnPolicyRunner as JaxRunner
    from geometry_rl_torch.train.runner import OnPolicyRunner

    jtr, js, _, _ = ref
    jrunner = object.__new__(JaxRunner)  # the runner over the fixture's agent
    jrunner.trainer, jrunner.state = jtr, js
    runner = OnPolicyRunner("cloth_hanging", algo="trpl", num_envs=2, steps_per_env=4, log_dir=str(tmp_path), device="cpu",
                            env_kwargs=dict(warmup_steps=0), **{k: v for k, v in SMALL.items() if k != "num_envs"})
    runner.state = port_state(jtr, js, runner.trainer)
    runner.trainer.policy.load_state_dict(params_from_flax(np_tree(js.actor_params)))
    obs = {k: torch.as_tensor(np.array(v)) for k, v in js.obs.items()}
    got = runner.get_inference_policy()(obs).numpy()
    want = np.asarray(jrunner.get_inference_policy()(js.obs))
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max()), np.abs(got - want).max()

    runner.learn(2)
    rows = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [1, 2] and all(np.isfinite(r["loss_critic"]) for r in rows)
    runner.save()
    saved = {k: v.clone() for k, v in runner.trainer.policy.state_dict().items()}
    before = runner.get_inference_policy()(obs)
    runner.learn(1)
    runner.load(str(tmp_path / "checkpoints"))
    assert all(torch.equal(v, saved[k]) for k, v in runner.trainer.policy.state_dict().items())
    assert runner.state.num_updates == 2 * runner.trainer.num_minibatches * runner.trainer.cfg.ppo_epochs
    assert torch.equal(runner.get_inference_policy()(obs), before)
