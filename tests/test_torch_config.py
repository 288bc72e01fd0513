"""The port's config loader against the JAX package's, on every shared YAML,
and `trainer_from_config`'s reading of it."""

import inspect

import pytest
import torch

from geometry_rl_tpu import config as jax_config
from geometry_rl_torch import config
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


def test_trainer_from_config_reads_the_config():
    cfg = config.load_config("cloth_hanging_multi_hepi_trpl", overrides={
        "env": {"num_envs": 2, "kwargs": {"warmup_steps": 0}}, "collector": {"frames_per_batch": 6},
        "algorithm": {"latent_dim": 8, "num_ori": 4, "dtype": "float32"},
    })
    tr = config.trainer_from_config(cfg, device="cpu")
    assert tr.env.cfg.num_envs == 2 and tr.cfg.steps_per_batch == 3
    assert tr.cfg.mini_batch_size == 200 and tr.cfg.total_iterations == 5_000_000 // 6
    hepi = tr.policy.backbone
    assert hepi.dtype == torch.float32 and hepi.num_ori == 4 and hepi.node_encoder.out_features == 8
    rigid = config.load_config("rigid_insertion_multi_hepi_trpl", overrides={
        "env": {"num_envs": 2, "kwargs": {"warmup_steps": 0}}, "algorithm": {"latent_dim": 8, "num_ori": 4},
    })
    tr = config.trainer_from_config(rigid, device="cpu")
    assert isinstance(tr.env, RigidEnv) and tr.cfg.steps_per_batch == 50_000 and tr.cfg.mini_batch_size == 1000
    assert tr.cfg.total_iterations == 200 and tr.policy.backbone.dtype == torch.bfloat16
    # both rope configs: 200 envs x 200 steps, minibatches of 200, and closing's projection bounds
    small = {"env": {"kwargs": {"warmup_steps": 0, "num_links": 10, "rope_length": 1.25}}, "algorithm": {"latent_dim": 8, "num_ori": 4}}
    for name, links, coeff, cov_bound in (("rope_closing_hepi_trpl", 40, 4.0, 0.001), ("rope_shaping_hepi_trpl", 80, None, None)):
        full = config.load_config(name)
        assert full["env"]["num_envs"] == 200 and full["collector"]["frames_per_batch"] == 200 * 200
        assert full["algorithm"]["objective"]["mini_batch_size"] == 200
        if coeff is not None:
            assert full["algorithm"]["projection"]["trust_region_coeff"] == coeff
            assert full["algorithm"]["projection"]["cov_bound"] == cov_bound
        tr = config.trainer_from_config(config.load_config(name, overrides=small), device="cpu")
        assert isinstance(tr.env, RopeEnv) and tr.env.cfg.num_envs == 200 and tr.env.cfg.num_links == 10
        assert tr.cfg.steps_per_batch == 200 and tr.cfg.mini_batch_size == 200
        assert tr.policy_builder.graph_levels == ("internal", "agent", "task")
        assert make_env(full["task"], num_envs=1, device="cpu").cfg.num_links == links
        proj = full["algorithm"]["projection"]
        assert tr.projection.trust_region_coeff == proj["trust_region_coeff"] and tr.projection.cov_bound == proj["cov_bound"]


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
