"""Agent builders (port of `geometry_rl_tpu/train/builders.py`): env + graph
or flat builders + policy and critic modules of every model family + the
projection of the algorithm, assembled into a Trainer."""

from __future__ import annotations

from typing import Optional

import torch

from .. import graphs
from ..declared import declared
from ..envs import make_env
from ..envs.cloth import ClothEnv
from ..envs.rigid import RigidEnv
from ..graphs.cloth import ClothGraphBuilder
from ..graphs.rigid import RigidGraphBuilder
from ..models import DeepSets, DiagGaussianPolicy, GraphValueNet, get_model
from ..rl.projections import get_projection_layer
from .ppo import TrainConfig, Trainer

# models whose equivariant vector output IS the action mean (post_fc=False)
EQUIVARIANT_MODELS = ("hepi", "ponita_gcn", "empn")
# models whose edge encoder reads the edge-type one-hot
EDGE_TYPED_MODELS = ("gcn", "meshgraphnet")


def _cloth_builder(env, dist_as_pos: bool, **builder_kw):
    return ClothGraphBuilder.from_env(env, dist_as_pos=dist_as_pos, full_graph_obs=not dist_as_pos, **builder_kw)


BUILT_IN_BUILDERS = {ClothEnv: _cloth_builder, RigidEnv: RigidGraphBuilder.from_env}


def make_graph_builder(env, dist_as_pos: bool, model: str = "", **builder_kw):
    """The task family's data layer, by env type: the built-in builders and
    those a module of `graphs/` declares in `BUILDERS` (env class ->
    `make(env, dist_as_pos=..., **builder_kw)`), the env's own class first.
    `dist_as_pos=True` marks the policy builder; the cloth critic additionally
    keeps the particle nodes. builder_kw forwards training_noise /
    training_noise_std."""
    builders = declared(graphs.__name__, "BUILDERS", BUILT_IN_BUILDERS, __file__)
    for cls in type(env).__mro__:
        if cls in builders:
            return builders[cls](env, dist_as_pos=dist_as_pos, **builder_kw)
    raise TypeError(f"no graph builder for {type(env).__name__}")


def build_policy(model_name: str, env, builder, latent_dim: int = 64, num_ori: int = 16, dtype=torch.float32,
                 contextual_std: bool = True, share_action_dim: bool = True, init_std: float = 1.0,
                 minimal_std: float = 1e-5, max_std: Optional[float] = None, **model_kw):
    """Policy module for a task. The torch modules take their input widths
    from `builder`; `model_kw` goes to the backbone."""
    cfg, device, name = env.cfg, env.device, model_name.lower()
    std_kw = dict(init_std=init_std, minimal_std=minimal_std, max_std=max_std)
    if name in EQUIVARIANT_MODELS:
        out_vec = cfg.action_dim // cfg.num_grippers // 3  # 2 (6D) or 1 (3D linear)
        if name == "hepi":
            model_kw = {"graph_levels": builder.graph_levels, **model_kw}
        backbone = get_model(
            name, in_scalars=builder.num_scalar_features, in_vectors=builder.num_vector_features, latent_dim=latent_dim,
            hidden_dim=latent_dim, output_dim=out_vec, output_dim_vec=out_vec, num_ori=num_ori, dtype=dtype, device=device,
            **model_kw,
        )
    else:
        if name in EDGE_TYPED_MODELS:
            model_kw = {"num_edge_types": len(builder.graph_levels), **model_kw}
        backbone = get_model(
            name, in_dim=builder.num_scalar_features + 3 * builder.num_vector_features, hidden_dim=latent_dim,
            output_dim=latent_dim, dtype=dtype, device=device, **model_kw,
        )
    head_in = latent_dim * (2 if model_kw.get("concat_global") else 1)  # the global token doubles the latent
    return DiagGaussianPolicy(
        backbone, head_in, action_dim=cfg.action_dim, num_actuators=cfg.num_grippers,
        share_action_dim=share_action_dim, contextual_std=contextual_std, post_fc=name not in EQUIVARIANT_MODELS,
        device=device, **std_kw,
    )


def build_critic(builder, latent_dim: int = 64, dtype=torch.float32, device=None):
    """DeepSets critic over the full graph, the one every reference config uses."""
    in_dim = builder.num_scalar_features + 3 * builder.num_vector_features
    backbone = DeepSets(in_dim, hidden_dim=latent_dim, output_dim=latent_dim, dtype=dtype, device=device)
    return GraphValueNet(backbone, latent_dim, device=device)


def build_agent(
    task: str = "cloth_hanging",
    model: str = "hepi",
    num_envs: int = 40,
    algo: str = "trpl",
    latent_dim: int = 64,
    num_ori: int = 16,
    mean_bound: float = 0.05,
    cov_bound: float = 0.0025,
    trust_region_coeff: float = 1.0,
    proj_type: str = "kl",
    train_cfg: Optional[TrainConfig] = None,
    env_kwargs: Optional[dict] = None,
    training_noise: bool = False,
    training_noise_std: float = 1e-2,
    entropy_schedule: Optional[str] = None,
    target_entropy: float = 0.0,
    temperature: float = 0.5,
    entropy_eq: bool = False,
    entropy_first: bool = False,
    dtype=torch.float32,
    device="cuda",
    **policy_kw,
) -> Trainer:
    """One call -> ready Trainer."""
    env = make_env(task, num_envs=num_envs, device=device, **(env_kwargs or {}))
    noise_kw = dict(training_noise=training_noise, training_noise_std=training_noise_std)
    policy_builder = make_graph_builder(env, dist_as_pos=True, model=model, **noise_kw)
    critic_builder = make_graph_builder(env, dist_as_pos=False, model=model, **noise_kw)
    policy = build_policy(model, env, policy_builder, latent_dim=latent_dim, num_ori=num_ori, dtype=dtype, **policy_kw)
    critic = build_critic(critic_builder, latent_dim=latent_dim, dtype=dtype, device=env.device)
    cfg = train_cfg or TrainConfig(algo=algo)
    # entropy schedules count network updates (the projection's `step` input)
    n_mb = max(1, cfg.steps_per_batch * num_envs // cfg.mini_batch_size)
    projection = get_projection_layer(
        proj_type if algo == "trpl" else "ppo",
        mean_bound=mean_bound,
        cov_bound=cov_bound,
        trust_region_coeff=trust_region_coeff,
        entropy_schedule_type=entropy_schedule,
        target_entropy=target_entropy,
        temperature=temperature,
        entropy_eq=entropy_eq,
        entropy_first=entropy_first,
        action_dim=env.cfg.action_dim,
        total_train_steps=cfg.total_iterations * cfg.ppo_epochs * n_mb,
    )
    return Trainer(env, policy, critic, cfg, policy_builder, critic_builder, projection=projection)
