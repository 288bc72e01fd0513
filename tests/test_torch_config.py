"""The port's config loader against the JAX package's, on every shared YAML,
and `trainer_from_config`'s reading of it."""

import dataclasses
import inspect

import pytest
import torch

import test_torch_common  # noqa: F401  (one torch thread per test worker)
from geometry_rl_tpu import config as jax_config
from geometry_rl_torch import config, models
from geometry_rl_torch.envs import ClothEnv, RigidEnv, RopeEnv, make_env
from geometry_rl_torch.train.builders import build_agent


@pytest.mark.parametrize("name", jax_config.available_configs())
def test_load_config_matches_reference(name):
    assert config.load_config(name) == jax_config.load_config(name)


def test_defaults_and_overrides_match_reference():
    assert config.DEFAULTS == jax_config.DEFAULTS
    assert config.available_configs() == jax_config.available_configs()
    overrides = {"env": {"num_envs": 3, "kwargs": {"warmup_steps": 0}}, "algorithm": {"dtype": "float32"}}
    assert config.load_config("cloth_hanging_multi_hepi_trpl", overrides) == jax_config.load_config(
        "cloth_hanging_multi_hepi_trpl", overrides
    )


TINY = {"env": {"num_envs": 2, "kwargs": {"warmup_steps": 0}}, "algorithm": {"latent_dim": 8, "num_ori": 4}}
ROPE_TINY = {"env": {"kwargs": {"warmup_steps": 0, "num_links": 10, "rope_length": 1.25}}, "algorithm": {"latent_dim": 8, "num_ori": 4}}
BACKBONES = {"hepi": models.HEPi, "empn": models.PonitaGCN, "transformer": models.TransformerVanilla}


@pytest.mark.parametrize("name", config.available_configs())
def test_trainer_from_config_reads_the_config(name):
    """`trainer_from_config` builds every shared YAML: the model family, its
    head (`post_fc`), bf16 activations over f32 params, and the config's
    sizes and algorithm settings."""
    full = config.load_config(name)
    rope = full["task"].startswith("rope")
    tr = config.trainer_from_config(config.load_config(name, overrides=ROPE_TINY if rope else TINY), device="cpu")
    assert len(config.available_configs()) == 15
    backbone = tr.policy.backbone
    assert type(backbone) is BACKBONES[full["model"]]
    assert tr.policy.post_fc == (full["model"] == "transformer")
    assert backbone.dtype == torch.bfloat16 and tr.critic.backbone.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in tr.policy.parameters())
    assert tr.env.cfg.num_envs == (200 if rope else 2)
    obj, proj = full["algorithm"]["objective"], full["algorithm"]["projection"]
    assert tr.cfg.steps_per_batch == full["collector"]["frames_per_batch"] // tr.env.cfg.num_envs
    assert tr.cfg.mini_batch_size == obj["mini_batch_size"] and tr.cfg.entropy_coef == obj["entropy_coef"]
    assert tr.cfg.clip_grad_norm == obj["clip_grad_norm"] and tr.cfg.max_grad_norm == obj["max_grad_norm"]
    assert tr.cfg.total_iterations == full["collector"]["total_frames"] // full["collector"]["frames_per_batch"]
    assert tr.projection.trust_region_coeff == proj["trust_region_coeff"] and tr.projection.cov_bound == proj["cov_bound"]
    assert isinstance(tr.env, {"cloth": ClothEnv, "rigid": RigidEnv, "rope": RopeEnv}[full["task"].split("_")[0]])
    if name == "cloth_hanging_multi_hepi_trpl":
        cfg = config.load_config(name, overrides={
            "env": {"num_envs": 2, "kwargs": {"warmup_steps": 0}}, "collector": {"frames_per_batch": 6},
            "algorithm": {"latent_dim": 8, "num_ori": 4, "dtype": "float32"},
        })
        tr = config.trainer_from_config(cfg, device="cpu")
        assert tr.env.cfg.num_envs == 2 and tr.cfg.steps_per_batch == 3
        assert tr.cfg.mini_batch_size == 200 and tr.cfg.total_iterations == 5_000_000 // 6
        hepi = tr.policy.backbone
        assert hepi.dtype == torch.float32 and hepi.num_ori == 4 and hepi.node_encoder.out_features == 8
    if name == "rigid_insertion_multi_hepi_trpl":
        assert tr.cfg.steps_per_batch == 50_000 and tr.cfg.mini_batch_size == 1000 and tr.cfg.total_iterations == 200
    if name == "rigid_insertion_two_agents_multi_hepi_trpl":
        # the std floor and cap and the gradient clip of that YAML
        assert tr.policy.minimal_std == 0.05 and tr.cfg.clip_grad_norm and tr.cfg.max_grad_norm == 1.0
        assert tr.policy.std_fn(torch.tensor(50.0)).item() == pytest.approx(1.2)
        assert tr.policy_builder.graph_levels == ("internal", "agent", "task") and tr.env.cfg.num_grippers == 2
    if name == "rigid_sliding_multi_hepi_trpl":
        assert tr.cfg.entropy_coef == 0.0005
    if rope:
        # both rope configs: 200 envs x 200 steps, minibatches of 200, and closing's projection bounds
        links, coeff, cov_bound = {"rope_closing_hepi_trpl": (40, 4.0, 0.001), "rope_shaping_hepi_trpl": (80, None, None)}[name]
        assert full["env"]["num_envs"] == 200 and full["collector"]["frames_per_batch"] == 200 * 200
        assert full["algorithm"]["objective"]["mini_batch_size"] == 200
        if coeff is not None:
            assert proj["trust_region_coeff"] == coeff and proj["cov_bound"] == cov_bound
        assert tr.env.cfg.num_links == 10 and tr.cfg.steps_per_batch == 200 and tr.cfg.mini_batch_size == 200
        assert tr.policy_builder.graph_levels == ("internal", "agent", "task")
        assert make_env(full["task"], num_envs=1, device="cpu").cfg.num_links == links


@pytest.mark.parametrize("entry", [config.trainer_from_config, build_agent, make_env, ClothEnv.__init__, RigidEnv.__init__,
                                   RopeEnv.__init__],
                         ids=["trainer_from_config", "build_agent", "make_env", "ClothEnv", "RigidEnv", "RopeEnv"])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """The programmatic entry points run on the card unless the caller asks
    for the CPU; with no card they raise instead of falling back."""
    assert inspect.signature(entry).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = config.load_config("cloth_hanging_multi_hepi_trpl", overrides={"env": {"num_envs": 2}})
    call = {
        "trainer_from_config": lambda: config.trainer_from_config(cfg),
        "build_agent": lambda: build_agent("cloth_hanging", "hepi", num_envs=2),
        "make_env": lambda: make_env("cloth_hanging", num_envs=2),
        "ClothEnv": lambda: ClothEnv(make_env("cloth_hanging", num_envs=2, device="cpu").cfg),
        "RigidEnv": lambda: RigidEnv(make_env("rigid_insertion", num_envs=2, device="cpu").cfg),
        "RopeEnv": lambda: RopeEnv(make_env("rope_closing", num_envs=2, device="cpu").cfg),
    }[entry.__qualname__.split(".")[0] if entry.__name__ == "__init__" else entry.__name__]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


@pytest.mark.parametrize("proj_type", ["kl", "frob", "w2", "w2_non_com", "papi", "ppo"])
@pytest.mark.parametrize("interval", ["minibatch", "iteration"])
@pytest.mark.parametrize("algo", ["trpl", "ppo", "kl_ppo"])
def test_trainer_from_config_builds_every_algorithm(algo, interval, proj_type):
    """Every algorithm x KL-penalty interval x projection the JAX loader
    takes: the same TrainConfig and the same projection layer (the
    projection is the identity for ppo and kl_ppo), and the KL-penalty
    coefficient only where the algorithm has one."""
    overrides = {**TINY, "algo": algo, "algorithm": {
        **TINY["algorithm"], "objective": {"kl_beta_interval": interval}, "projection": {"proj_type": proj_type}}}
    tr = config.trainer_from_config(config.load_config("rigid_insertion_multi_hepi_trpl", overrides), device="cpu")
    ref = jax_config.trainer_from_config(jax_config.load_config("rigid_insertion_multi_hepi_trpl", overrides))
    assert dataclasses.asdict(tr.cfg) == dataclasses.asdict(ref.cfg)
    assert type(tr.projection).__name__ == type(ref.projection).__name__
    assert type(tr.projection).__name__ == ("BaseProjection" if algo != "trpl" else
                                            {"kl": "KLProjection", "frob": "FrobeniusProjection", "papi": "PAPIProjection",
                                             "ppo": "BaseProjection"}.get(proj_type, "WassersteinProjection"))
    assert tr.projection.entropy_first == ref.projection.entropy_first
    state = tr.init(torch.Generator().manual_seed(0))
    assert (state.kl_beta is not None) == (algo == "kl_ppo")


def test_trainer_from_config_refuses_an_unknown_beta_interval():
    overrides = {**TINY, "algo": "kl_ppo", "algorithm": {**TINY["algorithm"], "objective": {"kl_beta_interval": "epoch"}}}
    for package in (config, jax_config):
        with pytest.raises(ValueError, match="kl_beta_interval"):
            package.trainer_from_config(package.load_config("rigid_insertion_multi_hepi_trpl", overrides),
                                        **({"device": "cpu"} if package is config else {}))


@pytest.mark.parametrize("entry", ["OnPolicyRunner", "runner.main", "bc_cli.main"])
def test_new_entry_points_default_to_the_card(entry, monkeypatch):
    """The runner, its command line and the behaviour-cloning command line run
    on the card unless told otherwise, and raise where there is none;
    rendering runs on its trainer's device."""
    from geometry_rl_torch.train import bc_cli, runner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if entry == "OnPolicyRunner":
        assert inspect.signature(runner.OnPolicyRunner).parameters["device"].default == "cuda"
        with pytest.raises(RuntimeError, match="device='cpu'"):
            runner.OnPolicyRunner("rigid_pushing", num_envs=2)
        return
    main, argv = {"runner.main": (runner.main, ["--num-envs", "2"]),
                  "bc_cli.main": (bc_cli.main, ["--config", "cloth_hanging_multi_hepi_trpl"])}[entry]
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(argv)
