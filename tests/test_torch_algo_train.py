"""One `_update` of each algorithm family and projection beyond TRPL with the
KL projection, in the port and in the JAX package: clipped PPO, KL-penalty
PPO with beta adapted per minibatch and per iteration, and TRPL with the
Frobenius and W2 projections.

One JAX agent (rigid_pushing, HEPi, latent 8, f32) collects one batch; for
each case its trainer takes the case's algorithm and projection, and both
packages run `_update` from that batch with the JAX permutations
substituted, as tests/test_torch_train.py and
tests/test_torch_models_train.py do.

Tolerances are tests/test_torch_train.py's: params within 1e-6 per Adam step
taken; aggregated metrics within 1e-4 relative and 1e-5 absolute. The
KL-penalty beta moves by exact factors of 2: it must be equal.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (pins torch to one thread per test worker)
from geometry_rl_tpu.rl.projections import get_projection_layer as jax_get_projection_layer
from geometry_rl_torch import convert
from geometry_rl_torch.rl.projections import get_projection_layer
from test_torch_common import frozen, np_tree, port_agent, reference_agent

STEPS = 3
CFG = dict(steps_per_batch=STEPS, mini_batch_size=6, ppo_epochs=2, total_iterations=10)
SMALL = dict(num_envs=4, latent_dim=8, num_ori=4, env_kwargs=dict(warmup_steps=0))
PROJ = dict(mean_bound=0.05, cov_bound=0.0025, trust_region_coeff=1.0)
# id: (TrainConfig fields, projection type)
CASES = {
    "ppo": (dict(algo="ppo"), "ppo"),
    "ppo-anneal_clip": (dict(algo="ppo", anneal_clip_epsilon=True, clip_value=0.5), "ppo"),
    "kl_ppo-minibatch": (dict(algo="kl_ppo", kl_beta_interval="minibatch"), "ppo"),
    "kl_ppo-iteration": (dict(algo="kl_ppo", kl_beta_interval="iteration", kl_beta=4.0), "ppo"),
    "trpl-frob": (dict(algo="trpl"), "frob"),
    "trpl-w2": (dict(algo="trpl"), "w2"),
}


@functools.lru_cache(maxsize=None)
def jax_agent():
    """The JAX agent and its collected batch, shared by every case (each
    case's update reads them and leaves them as they are)."""
    jtr, js0 = reference_agent("rigid_pushing", "hepi", frozen(**SMALL), frozen(**CFG), seed=4)
    js1, jbatch, _ = jax.jit(jtr._collect)(js0)
    return jtr, js1, jbatch


def run(case):
    train_kw, proj_type = CASES[case]
    jtr, js1, jbatch = jax_agent()
    cfg0, proj0 = jtr.cfg, jtr.projection
    jtr.cfg = dataclasses.replace(cfg0, **train_kw)
    jtr.projection = jax_get_projection_layer(proj_type, **PROJ, action_dim=jtr.env.cfg.action_dim)
    try:
        if jtr.cfg.algo == "kl_ppo":
            js1 = js1._replace(kl_beta=jnp.asarray(jtr.cfg.kl_beta, jnp.float32))
        # a fresh function: jit traces it with this case's config
        js2, jm = jax.jit(lambda s, b: jtr._update(s, b))(js1, jbatch)
    finally:
        jtr.cfg, jtr.projection = cfg0, proj0

    ttr, state = port_agent("rigid_pushing", "hepi", js1, frozen(**SMALL), frozen(**CFG, **train_kw))
    ttr.projection = get_projection_layer(proj_type, **PROJ, action_dim=ttr.env.cfg.action_dim)
    state = state._replace(norm=convert.obs_norm_from_jax(np_tree(js1.norm)),
                           obs={k: torch.as_tensor(np.array(v)) for k, v in js1.obs.items()})
    assert (state.kl_beta is None) == (train_kw["algo"] != "kl_ppo")
    key, perms = js1.key, []
    n, n_mb, mb = STEPS * SMALL["num_envs"], jtr.num_minibatches, jtr.mini_batch_size
    for _ in range(CFG["ppo_epochs"]):
        key, k_perm = jax.random.split(key)
        perms.append(torch.as_tensor(np.array(jax.random.permutation(k_perm, n)[: n_mb * mb].reshape(n_mb, mb))))
    perm_iter = iter(perms)
    ttr._permutation = lambda generator, n: next(perm_iter)
    state, tm = ttr._update(state, convert.batch_from_jax(np_tree(jbatch)))
    return ttr, state, tm, np_tree(js2), jm


@pytest.mark.parametrize("case", list(CASES))
def test_update_matches_reference(case):
    ttr, state, tm, js2, jm = run(case)
    steps = CFG["ppo_epochs"] * 2
    assert state.num_updates == int(js2.num_updates) == steps
    for part, ref_tree in (("policy", js2.actor_params), ("critic", js2.critic_params)):
        ref = convert.params_from_flax(ref_tree)
        for k, v in getattr(ttr, part).state_dict().items():
            np.testing.assert_allclose(v.numpy(), ref[k].numpy(), atol=steps * 1e-6, rtol=0, err_msg=f"{part}.{k}")
    assert sorted(tm) == sorted(jm)
    for k, v in jm.items():
        np.testing.assert_allclose(tm[k].item(), float(v), rtol=1e-4, atol=1e-5, err_msg=k)
    if ttr.cfg.algo == "kl_ppo":
        assert state.kl_beta.item() == float(js2.kl_beta)
        if case == "kl_ppo-minibatch":  # the KL stays under dtarg / 1.5: one halving per minibatch
            assert state.kl_beta.item() == 0.5**steps and tm["kl_penalty_beta_max"].item() == 1.0
        else:  # held over the phase, then adapted once
            assert tm["kl_penalty_beta"].item() == 4.0 and state.kl_beta.item() != 4.0
    else:
        assert state.kl_beta is None
    if ttr.cfg.algo == "ppo":
        assert "clip_fraction" in tm and "loss_trust_region" not in tm


def test_kl_beta_and_papi_state_round_trip_through_checkpoints(tmp_path, capsys):
    """`kl_beta` is saved and restored with the TrainState; a checkpoint
    without it (an older one) restores and keeps the template's value; PAPI's
    carry round-trips through `save_tree` / `restore_tree`, and the CLI warns
    when a resumed PAPI run finds no `<checkpoints>_papi`."""
    from geometry_rl_torch.rl.projections import papi
    from geometry_rl_torch.train import TrainConfig, cli
    from geometry_rl_torch.train.builders import build_agent
    from geometry_rl_torch.train.checkpoint import STATE_FILE, restore_checkpoint, restore_tree, save_checkpoint, save_tree

    tr = build_agent("rigid_pushing", "mlp", device="cpu", num_envs=2, latent_dim=4, contextual_std=False,
                     env_kwargs=dict(warmup_steps=0), train_cfg=TrainConfig(algo="kl_ppo", steps_per_batch=2, mini_batch_size=2))
    state = tr.init(torch.Generator().manual_seed(0))._replace(kl_beta=torch.tensor(0.125))
    save_checkpoint(str(tmp_path / "c"), 0, tr, state)
    template = tr.init(torch.Generator().manual_seed(1))
    assert template.kl_beta.item() == 1.0
    assert restore_checkpoint(str(tmp_path / "c"), tr, template).kl_beta.item() == 0.125
    path = tmp_path / "c" / "0" / STATE_FILE
    payload = torch.load(path, weights_only=True)
    del payload["state"]["kl_beta"]
    torch.save(payload, path)
    assert restore_checkpoint(str(tmp_path / "c"), tr, template).kl_beta.item() == 1.0

    carry = tr.papi_init(state)
    carry = papi.PAPIState({k: v + 1.0 for k, v in carry.history.items()}, torch.tensor(3, dtype=torch.int32),
                           torch.tensor(0.81))
    save_tree(str(tmp_path / "p"), 5, carry)
    back = restore_tree(str(tmp_path / "p"), tr.papi_init(state))
    assert int(back.hist_len) == 3 and back.lr_scale.item() == np.float32(0.81)
    assert all(torch.equal(back.history[k], v) for k, v in carry.history.items())

    # the cloth Transformer: one pre_std of 3 shared by four grippers' 12 action dims
    config = "cloth_hanging_multi_transformer_trpl"
    overrides = ["--override", "env.num_envs=2", "env.kwargs.warmup_steps=0", "env.kwargs.episode_length=3",
                 "collector.frames_per_batch=4", "collector.total_frames=8", "algorithm.latent_dim=4",
                 "algorithm.objective.mini_batch_size=2", "algorithm.projection.proj_type=papi",
                 "algorithm.policy.contextual_std=false", "algorithm.objective.papi_steps=true"]
    run = cli.main(["--config", config, "--device", "cpu", *overrides, f"logger.log_dir={tmp_path / 'a'}"])
    rows = [json.loads(line) for line in open(f"{run}/metrics.jsonl")]
    assert all(np.isfinite(r["papi/n_backtracks"]) and 0.0 < r["papi/lr_scale"] <= 1.0 for r in rows)
    ckpt = tmp_path / "only_main"
    import shutil

    shutil.copytree(f"{run}/checkpoints", ckpt)
    capsys.readouterr()
    cli.main(["--config", config, "--device", "cpu", "--resume", str(ckpt), *overrides,
              "collector.total_frames=12", f"logger.log_dir={tmp_path / 'b'}"])
    assert "WARNING: no PAPI state" in capsys.readouterr().out
    cli.main(["--config", config, "--device", "cpu", "--resume", f"{run}/checkpoints",
              *overrides, "collector.total_frames=12", f"logger.log_dir={tmp_path / 'c2'}"])
    assert "Resumed PAPI state" in capsys.readouterr().out
