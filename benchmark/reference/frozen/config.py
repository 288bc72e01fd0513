"""The trainer builder of the frozen copy: `trainer_from_config` turns a
resolved config dict (as the benchmark's configuration files hold it) into
the copy's Trainer.
"""

from __future__ import annotations

from typing import Dict

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def trainer_from_config(cfg: Dict, device="cuda"):
    """Build the Trainer from a loaded config dict. Parameters stay float32;
    activations run in `algorithm.dtype`."""
    from .train.builders import build_agent
    from .train.ppo import TrainConfig

    num_envs = cfg["env"]["num_envs"]
    obj = cfg["algorithm"]["objective"]
    opt = cfg["algorithm"]["optim"]
    beta_interval = obj.get("kl_beta_interval", "minibatch")
    if beta_interval not in ("minibatch", "iteration"):
        # any other value would silently fall back to the per-minibatch controller
        raise ValueError(f"kl_beta_interval must be 'minibatch' or 'iteration', got {beta_interval!r}")
    train_cfg = TrainConfig(
        algo=cfg["algo"],
        steps_per_batch=max(1, cfg["collector"]["frames_per_batch"] // num_envs),
        ppo_epochs=obj["ppo_epochs"],
        mini_batch_size=obj["mini_batch_size"],
        gamma=obj["gamma"],
        gae_lambda=obj["gae_lambda"],
        lr=opt["lr"],
        anneal_lr=opt["anneal_lr"],
        total_iterations=max(1, cfg["collector"]["total_frames"] // cfg["collector"]["frames_per_batch"]),
        clip_epsilon=obj["clip_epsilon"],
        anneal_clip_epsilon=obj["anneal_clip_epsilon"],
        entropy_coef=obj["entropy_coef"],
        critic_coef=obj["critic_coef"],
        clip_value=obj["clip_value"],
        loss_critic_type=obj["loss_critic_type"],
        normalize_advantage=obj["normalize_advantage"],
        entropy_bonus=obj["entropy_bonus"],
        max_grad_norm=obj["max_grad_norm"],
        clip_grad_norm=obj["clip_grad_norm"],
        dtarg=obj.get("dtarg", 0.01),
        kl_beta=obj.get("kl_beta", 1.0),
        kl_increment=obj.get("kl_increment", 2.0),
        kl_decrement=obj.get("kl_decrement", 0.5),
        kl_beta_interval=beta_interval,
        papi_steps=obj.get("papi_steps", False),
        papi_history=obj.get("papi_history", 8),
        papi_iters=obj.get("papi_iters", 20),
        papi_lr_decay=obj.get("papi_lr_decay", 0.9),
    )
    policy = cfg["algorithm"]["policy"]
    proj = cfg["algorithm"]["projection"]
    return build_agent(
        task=cfg["task"],
        model=cfg["model"],
        num_envs=num_envs,
        algo=cfg["algo"],
        latent_dim=cfg["algorithm"]["latent_dim"],
        num_ori=cfg["algorithm"]["num_ori"],
        dtype=DTYPES[cfg["algorithm"].get("dtype", "float32")],
        mean_bound=proj["mean_bound"],
        cov_bound=proj["cov_bound"],
        trust_region_coeff=proj["trust_region_coeff"],
        proj_type=proj["proj_type"],
        entropy_schedule=proj.get("entropy_schedule"),
        target_entropy=proj.get("target_entropy", 0.0),
        temperature=proj.get("temperature", 0.5),
        entropy_eq=proj.get("entropy_eq", False),
        entropy_first=proj.get("entropy_first", False),
        training_noise=cfg["algorithm"].get("training_noise", False),
        training_noise_std=cfg["algorithm"].get("training_noise_std", 1e-2),
        train_cfg=train_cfg,
        env_kwargs=cfg["env"].get("kwargs") or {},
        device=device,
        contextual_std=policy.get("contextual_std", True),
        share_action_dim=policy.get("share_action_dim", True),
        init_std=policy.get("init_std", 1.0),
        minimal_std=policy.get("minimal_std", 1e-5),
        max_std=policy.get("max_std", None),
    )
