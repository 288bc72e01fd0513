"""The on-policy trainer, pruned to the cells' path (TRPL in one process)
from the port's `train/ppo.py`.

One `train_iteration`: collect T control steps (simulator, observation
pipeline, graph builders, policy and critic forward) -> GAE -> ppo_epochs x
minibatches of the TRPL loss with its trust-region projection, backward and
Adam. The policy and critic parameters live in their `nn.Module`s and the
Adam states in the TrainState.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from ..models.calibration import calibrate
from ..models.common import init_params
from ..rl import gaussian as G
from ..rl.gae import gae
from ..rl.losses import LossInputs, trpl_loss
from ..rl.obs_pipeline import ObsNormState, obs_norm_apply, obs_norm_init, obs_norm_step
from ..rl.projections import BaseProjection


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Mirrors the reference's `TrainConfig` (algorithm objective/optim groups)."""

    algo: str = "trpl"  # trpl | ppo | kl_ppo
    steps_per_batch: int = 100  # control steps per env per iteration
    ppo_epochs: int = 5
    mini_batch_size: int = 1000
    gamma: float = 0.99
    gae_lambda: float = 0.95
    lr: float = 3e-4
    anneal_lr: bool = False
    total_iterations: int = 200
    clip_epsilon: float = 0.2
    anneal_clip_epsilon: bool = False
    entropy_coef: float = 0.005
    critic_coef: float = 0.5
    clip_value: float = 0.2
    loss_critic_type: str = "l2"
    normalize_advantage: bool = True
    entropy_bonus: bool = True
    max_grad_norm: float = 1.0
    clip_grad_norm: bool = False
    dtarg: float = 0.01
    kl_beta: float = 1.0
    kl_increment: float = 2.0
    kl_decrement: float = 0.5
    kl_beta_interval: str = "minibatch"
    papi_steps: bool = False
    papi_history: int = 8
    papi_iters: int = 20
    papi_lr_decay: float = 0.9


class TrainState(NamedTuple):
    actor_opt: torch.optim.Adam  # over the policy module's parameters
    critic_opt: torch.optim.Adam  # over the critic module's parameters
    norm: ObsNormState
    env_state: object
    obs: Dict[str, torch.Tensor]  # raw obs of the current env state
    generator: torch.Generator  # action sampling and minibatch permutations
    num_updates: int  # network updates so far (lr anneal, projection step)
    initial_entropy: torch.Tensor  # mean policy entropy at init
    kl_beta: Optional[torch.Tensor] = None  # KL-penalty coefficient, 0-d f32 (algo "kl_ppo" only)


class Batch(NamedTuple):
    tobs: Dict[str, torch.Tensor]  # transformed obs groups [T, B, D]
    action: torch.Tensor  # [T, B, A]
    log_prob: torch.Tensor  # [T, B]
    mean: torch.Tensor  # [T, B, A] behavior dist
    std: torch.Tensor  # [T, B, A]
    value: torch.Tensor  # [T, B]
    reward: torch.Tensor
    done: torch.Tensor


def split_generator(generator: torch.Generator, n: int) -> Tuple[torch.Generator, ...]:
    """n independent generators seeded from `generator` (jax.random.split's
    role; advances `generator`)."""
    seeds = torch.randint(0, 2**62, (n,), generator=generator, device=generator.device).tolist()
    return tuple(torch.Generator(device=generator.device).manual_seed(s) for s in seeds)


def fold_in(generator: torch.Generator, data: int) -> torch.Generator:
    """A generator derived from `generator`'s state and `data`, leaving
    `generator` untouched (jax.random.fold_in's role)."""
    digest = hashlib.blake2b(generator.get_state().numpy().tobytes() + data.to_bytes(8, "little"), digest_size=8).digest()
    return torch.Generator(device=generator.device).manual_seed(int.from_bytes(digest, "little") >> 2)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of squares over all tensors."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


class Trainer:
    """Wires env + graph builders + policy/critic modules + projection into
    the rollout and the update."""

    NOISE_SEED = 0x6E015E  # the training noise's base seed

    def __init__(self, env, policy, critic, cfg: TrainConfig, policy_builder, critic_builder,
                 projection: Optional[BaseProjection] = None):
        self.env = env
        self.num_envs = env.cfg.num_envs
        self.policy = policy
        self.critic = critic
        self.cfg = cfg
        self.policy_builder = policy_builder
        self.critic_builder = critic_builder
        self.projection = projection
        self.device = env.device

        n_samples = cfg.steps_per_batch * self.num_envs
        self.num_minibatches = max(1, n_samples // cfg.mini_batch_size)
        self.mini_batch_size = min(cfg.mini_batch_size, n_samples)
        self.total_network_updates = cfg.total_iterations * cfg.ppo_epochs * self.num_minibatches

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ init

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> TrainState:
        env = self.env
        g_env, g_actor, g_critic, g_rest = split_generator(generator, 4)
        env_state = env.reset(g_env)
        obs = env.observe(env_state)
        norm = obs_norm_init(env.obs_spec.group_dim("scalars"), self.device)
        tobs = obs_norm_apply(norm, obs)

        g_p, f_p = self.policy_builder.build(tobs)
        init_params(self.policy, g_actor)
        calibrate(self.policy, g_p, f_p)
        initial_entropy = G.entropy(self.policy(g_p, f_p)).mean()
        g_c, f_c = self.critic_builder.build(tobs)
        init_params(self.critic, g_critic)
        calibrate(self.critic, g_c, f_c)
        return TrainState(
            *self._optimizers(),
            norm=norm, env_state=env_state, obs=obs, generator=g_rest, num_updates=0,
            initial_entropy=initial_entropy,
            kl_beta=torch.full((), self.cfg.kl_beta, device=self.device) if self.cfg.algo == "kl_ppo" else None,
        )

    def _optimizers(self) -> Tuple[torch.optim.Adam, torch.optim.Adam]:
        return (torch.optim.Adam(self.policy.parameters(), lr=self.cfg.lr, eps=1e-5),
                torch.optim.Adam(self.critic.parameters(), lr=self.cfg.lr, eps=1e-5))

    # --------------------------------------------------------------- forward

    def _policy_dist(self, tobs, env_ids=None, noise_generator=None) -> G.DiagGaussian:
        graph, feats = self.policy_builder.build(tobs, env_ids, noise_generator)
        return self.policy(graph, feats)

    def _value(self, tobs, env_ids=None, noise_generator=None) -> torch.Tensor:
        graph, feats = self.critic_builder.build(tobs, env_ids, noise_generator)
        return self.critic(graph, feats)

    # --------------------------------------------------------------- collect

    @torch.no_grad()
    def _collect(self, state: TrainState) -> Tuple[TrainState, Batch, Dict[str, torch.Tensor]]:
        env = self.env
        B = env.cfg.num_envs
        env_state, obs, norm, gen = state.env_state, state.obs, state.norm, state.generator
        cum_rew = torch.zeros(B, device=self.device)
        ep_sum = torch.zeros((), device=self.device)
        ep_cnt = torch.zeros((), dtype=torch.int64, device=self.device)
        steps = []
        for _ in range(self.cfg.steps_per_batch):
            norm, tobs = obs_norm_step(norm, obs, update=True)
            dist = self._policy_dist(tobs)
            action = G.sample(gen, dist)
            log_prob = G.log_prob(dist, action)
            value = self._value(tobs)

            env_state, ts = env.step(env_state, action)

            cum_rew = cum_rew + ts.reward
            ep_sum = ep_sum + torch.where(ts.done, cum_rew, 0.0).sum()
            ep_cnt = ep_cnt + ts.done.sum()
            cum_rew = torch.where(ts.done, 0.0, cum_rew)
            steps.append(Batch(tobs, action, log_prob, dist.mean, dist.std, value, ts.reward, ts.done))
            obs = ts.obs

        batch = Batch(
            tobs={k: torch.stack([s.tobs[k] for s in steps]) for k in steps[0].tobs},
            **{f: torch.stack([getattr(s, f) for s in steps]) for f in Batch._fields if f != "tobs"},
        )
        new_state = state._replace(env_state=env_state, obs=obs, norm=norm)
        stats = {
            "train/reward": torch.where(ep_cnt > 0, ep_sum / torch.clamp(ep_cnt, min=1), torch.nan),
            "train/episodes": ep_cnt.float(),
        }
        return new_state, batch, stats

    # ---------------------------------------------------------------- update

    def _minibatch_loss(self, mb: Dict, num_updates: int, initial_entropy=None, kl_beta=None):
        """Total loss (actor + critic) of one minibatch and (its metrics, the
        KL-penalty beta for the next minibatch: adapted for "kl_ppo", else
        `kl_beta` as given)."""
        cfg = self.cfg
        # training-noise augmentation: a fresh draw per network update, on
        # training forwards only
        nk_a = nk_c = None
        if self.policy_builder.training_noise or self.critic_builder.training_noise:
            base = torch.Generator(device=self.device).manual_seed(self.NOISE_SEED)
            nk_a, nk_c = split_generator(fold_in(base, num_updates), 2)
        dist = self._policy_dist(mb["tobs"], mb["env_ids"], nk_a)
        value = self._value(mb["tobs"], mb["env_ids"], nk_c)
        inputs = LossInputs(
            action=mb["action"], sample_log_prob=mb["log_prob"], advantage=mb["advantage"],
            value_target=mb["value_target"], old_value=mb["value"],
        )
        common = dict(entropy_coef=cfg.entropy_coef, critic_coef=cfg.critic_coef, loss_critic_type=cfg.loss_critic_type,
                      normalize_advantage=cfg.normalize_advantage, entropy_bonus=cfg.entropy_bonus)
        old_dist = G.DiagGaussian(mb["mean"], mb["std"])
        if cfg.algo != "trpl":
            raise ValueError(f"the reference runs TRPL only, not {cfg.algo!r}")
        actor_loss, critic_loss, metrics = trpl_loss(
            dist, old_dist, value, inputs, self.projection, step=num_updates, initial_entropy=initial_entropy,
            clip_value=cfg.clip_value, **common,
        )
        return actor_loss + critic_loss, (metrics, kl_beta)

    def _permutation(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """One epoch's minibatch indices [n_mb, mb_size]: a permutation of the
        n samples, truncated to n_mb * mb_size."""
        n_mb, mb_size = self.num_minibatches, self.mini_batch_size
        perm = torch.randperm(n, generator=generator, device=generator.device)
        return perm[: n_mb * mb_size].reshape(n_mb, mb_size).to(self.device)

    def _optimizer_step(self, opt: torch.optim.Adam, num_updates: int, lr_scale: Optional[float] = None) -> None:
        """optax's chain: clip_by_global_norm (g * max / norm where norm >
        max) before Adam, Adam's lr annealed linearly over the run's updates.
        `lr_scale` multiplies this step's update: Adam's update is linear in
        its lr, so the step runs at lr * lr_scale and the lr is put back
        after it."""
        cfg = self.cfg
        params = [p for group in opt.param_groups for p in group["params"] if p.grad is not None]
        if cfg.clip_grad_norm:
            norm = global_norm([p.grad for p in params])
            for p in params:
                p.grad.copy_(torch.where(norm < cfg.max_grad_norm, p.grad, p.grad / norm * cfg.max_grad_norm))
        if cfg.anneal_lr:
            frac = 1.0 - min(num_updates, self.total_network_updates) / self.total_network_updates
            for group in opt.param_groups:
                group["lr"] = cfg.lr * frac
        if lr_scale is None:
            opt.step()
            return
        lrs = [group["lr"] for group in opt.param_groups]
        for group, lr in zip(opt.param_groups, lrs):
            group["lr"] = lr * lr_scale
        opt.step()
        for group, lr in zip(opt.param_groups, lrs):
            group["lr"] = lr

    def _minibatch_step(self, state: TrainState, mb: Dict, num_updates: int, kl_beta: Optional[torch.Tensor] = None,
                        lr_scale: Optional[float] = None) -> Tuple[Dict[str, torch.Tensor], Optional[torch.Tensor]]:
        """Loss, backward, and one Adam step of actor and critic. Returns the
        metrics and the KL-penalty beta for the next minibatch."""
        state.actor_opt.zero_grad(set_to_none=True)
        state.critic_opt.zero_grad(set_to_none=True)
        loss, (metrics, kl_beta) = self._minibatch_loss(mb, num_updates, state.initial_entropy, kl_beta)
        loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        # pre-clip gradient magnitude; `_max` aggregates as a max below
        gn = global_norm([p.grad for p in self.policy.parameters() if p.grad is not None])
        metrics["grad_norm_actor"] = metrics["grad_norm_actor_max"] = gn
        self._optimizer_step(state.actor_opt, num_updates, lr_scale)
        self._optimizer_step(state.critic_opt, num_updates, lr_scale)
        return metrics, kl_beta

    def _global_var(self, x: torch.Tensor) -> torch.Tensor:
        return x.var(correction=0)

    def _update_data(self, state: TrainState, batch: Batch) -> Dict:
        """GAE (bootstrapped with the current critic on the post-rollout
        observation) and the batch flattened [T, B] -> [T*B]."""
        cfg = self.cfg
        B, T = self.env.cfg.num_envs, cfg.steps_per_batch
        with torch.no_grad():
            _, final_tobs = obs_norm_step(state.norm, state.obs, update=False)
            bootstrap = self._value(final_tobs)
            advantage, value_target = gae(
                batch.reward, batch.value, batch.done.float(), bootstrap, cfg.gamma, cfg.gae_lambda
            )

        def flat(x):
            return x.reshape((T * B,) + x.shape[2:])

        return {
            "tobs": {k: flat(v) for k, v in batch.tobs.items()},
            "action": flat(batch.action),
            "log_prob": flat(batch.log_prob),
            "mean": flat(batch.mean),
            "std": flat(batch.std),
            "value": flat(batch.value),
            "advantage": flat(advantage),
            "value_target": flat(value_target),
            "env_ids": torch.arange(B, device=self.device).repeat(T),
        }

    @staticmethod
    def _minibatch(data: Dict, idx: torch.Tensor) -> Dict:
        """The samples `idx` of `_update_data`'s flattened batch."""
        return {k: ({g: x[idx] for g, x in v.items()} if k == "tobs" else v[idx]) for k, v in data.items()}

    def _update(self, state: TrainState, batch: Batch, lr_scale: Optional[float] = None
                ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """ppo_epochs x minibatches of loss, backward and Adam; `lr_scale`
        (PAPI's LR annealing) multiplies every Adam update."""
        cfg = self.cfg
        data = self._update_data(state, batch)
        n = cfg.steps_per_batch * self.num_envs
        num_updates, kl_beta = state.num_updates, state.kl_beta
        stacked: Dict[str, List[torch.Tensor]] = {}
        for _ in range(cfg.ppo_epochs):
            perm = self._permutation(state.generator, n)
            for idx in perm:
                mb = self._minibatch(data, idx)
                metrics, kl_beta = self._minibatch_step(state, mb, num_updates, kl_beta, lr_scale)
                for k, v in metrics.items():
                    stacked.setdefault(k, []).append(v)
                num_updates += 1
        # means over the epoch x minibatch stack, except the `_max` keys,
        # which aggregate as true maxes
        metrics = {k: (torch.stack(v).max() if k.endswith("_max") else torch.stack(v).mean()) for k, v in stacked.items()}
        vt, v = data["value_target"], data["value"]
        metrics["train/explained_variance"] = 1.0 - self._global_var(vt - v) / torch.clamp(self._global_var(vt), min=1e-8)
        return state._replace(num_updates=num_updates, kl_beta=kl_beta), metrics

    # -------------------------------------------------------------- full step

    def train_iteration(self, state: TrainState) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """Collect, then update. Also reports each half's seconds, ending in a
        device synchronize (`train/collect_time`, `train/update_time`)."""
        self._sync()
        t0 = time.perf_counter()
        state, batch, collect_stats = self._collect(state)
        self._sync()
        t1 = time.perf_counter()
        state, metrics = self._update(state, batch)
        self._sync()
        metrics.update(collect_stats)
        metrics["train/collect_time"] = torch.tensor(t1 - t0)
        metrics["train/update_time"] = torch.tensor(time.perf_counter() - t1)
        return state, metrics

    # ------------------------------------------------------------------ eval

    def _eval_steps(self, state: TrainState, n_steps: int, deterministic: bool, fold: int):
        """Reset from a generator folded out of the state's, then roll the
        policy for `n_steps`, yielding each env step's TimeStep."""
        gen = fold_in(state.generator, fold)
        env_state = self.env.reset(gen)
        obs = self.env.observe(env_state)
        for _ in range(n_steps):
            _, tobs = obs_norm_step(state.norm, obs, update=False)
            dist = self._policy_dist(tobs)
            action = dist.mean if deterministic else G.sample(gen, dist)
            env_state, ts = self.env.step(env_state, action)
            yield ts
            obs = ts.obs
