"""On-policy trainer: TRPL, clipped PPO and KL-penalty PPO (port of
`geometry_rl_tpu/train/ppo.py`).

One `train_iteration` is the reference's: collect T control steps (simulator
and kernel, observation pipeline, graph builders, policy and critic forward)
-> GAE -> ppo_epochs x minibatches of the algorithm's loss (TRPL with its
trust-region projection, clipped PPO, or KL-penalty PPO with its adaptive
beta), backward and Adam. `train_iteration_papi` adds PAPI's post-update
steps. Python loops take the place of `lax.scan`; the policy and critic
parameters live in their `nn.Module`s and the Adam states in the TrainState.

With `dp` (`parallel.mesh.DataParallel`) the trainer is one process of an
env-axis data-parallel run: its env holds this rank's row block of the
global batch, and it computes what one process computes at the global
`num_envs`. Random draws are made at the global width; the normaliser's
sums, the gradients, the metrics and the losses' minibatch reductions are
totalled over the ranks; every rank draws the same permutation of the
global batch and trains on the samples of its own envs.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from ..models.calibration import calibrate
from ..models.common import init_params
from ..parallel.mesh import DataParallel, RowGenerator, Rows, global_batch, replicate, shard_train_state
from ..rl import gaussian as G
from ..rl.gae import gae
from ..rl.losses import LossInputs, adapt_kl_beta, kl_pen_ppo_loss, ppo_clip_loss, trpl_loss
from ..rl.obs_pipeline import ObsNormState, obs_norm_apply, obs_norm_init, obs_norm_step
from ..rl.projections import BaseProjection
from ..rl.projections.papi import PAPIState, find_papi_paths, papi_init_state, papi_steps
from ..utils.trace import span, spanned


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
                 projection: Optional[BaseProjection] = None, dp: Optional[DataParallel] = None):
        self.env = env
        self.dp = dp
        self.rows: Optional[Rows] = env.rows  # this rank's envs of the global batch (None: all of them)
        self.num_envs = env.cfg.num_envs if dp is None else env.rows.total  # the global batch's envs
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
    @spanned("setup.init")
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

    def init_from(self, full: "Trainer", generator: torch.Generator) -> TrainState:
        """The data-parallel init: `full` (this trainer's twin at the global
        width, in one process) builds the whole initial state from
        `generator` as one process would, calibrating on every env; this rank
        keeps its rows of the env state and observation, takes the params
        (rank 0's, so that the ranks hold the same bits) and makes its own
        Adam states."""
        state = full.init(generator)
        for mine, theirs in ((self.policy, full.policy), (self.critic, full.critic)):
            mine.load_state_dict(theirs.state_dict())
            replicate(mine, self.dp)
        state = shard_train_state(state, self.rows, self.num_envs)
        return state._replace(**dict(zip(("actor_opt", "critic_opt"), self._optimizers())))

    def _total(self, *tensors: torch.Tensor) -> List[torch.Tensor]:
        """Each tensor summed over the ranks (as it is in one process)."""
        return list(tensors) if self.dp is None else self.dp.all_reduce(list(tensors))

    # --------------------------------------------------------------- forward

    @spanned("train.policy")
    def _policy_dist(self, tobs, env_ids=None, noise_generator=None) -> G.DiagGaussian:
        with span("graphs.build"):
            graph, feats = self.policy_builder.build(tobs, env_ids, noise_generator)
        with span("models.forward"):
            return self.policy(graph, feats)

    @spanned("train.critic")
    def _value(self, tobs, env_ids=None, noise_generator=None) -> torch.Tensor:
        with span("graphs.build"):
            graph, feats = self.critic_builder.build(tobs, env_ids, noise_generator)
        with span("models.forward"):
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
            norm, tobs = obs_norm_step(norm, obs, update=True, dp=self.dp)
            dist = self._policy_dist(tobs)
            action = G.sample(gen, dist, rows=self.rows)
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
        ep_sum, ep_cnt = self._total(ep_sum, ep_cnt)
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
            if self.dp is not None:  # drawn over the global minibatch; this rank's samples kept
                nk_a, nk_c = RowGenerator(nk_a, mb["rows"]), RowGenerator(nk_c, mb["rows"])
        dist = self._policy_dist(mb["tobs"], mb["env_ids"], nk_a)
        value = self._value(mb["tobs"], mb["env_ids"], nk_c)
        inputs = LossInputs(
            action=mb["action"], sample_log_prob=mb["log_prob"], advantage=mb["advantage"],
            value_target=mb["value_target"], old_value=mb["value"],
        )
        common = dict(entropy_coef=cfg.entropy_coef, critic_coef=cfg.critic_coef, loss_critic_type=cfg.loss_critic_type,
                      normalize_advantage=cfg.normalize_advantage, entropy_bonus=cfg.entropy_bonus)
        old_dist = G.DiagGaussian(mb["mean"], mb["std"])
        if cfg.algo == "trpl":
            actor_loss, critic_loss, metrics = trpl_loss(
                dist, old_dist, value, inputs, self.projection, step=num_updates, initial_entropy=initial_entropy,
                clip_value=cfg.clip_value, **common,
            )
        elif cfg.algo == "kl_ppo":
            # the critic loss unclipped; with kl_beta_interval "iteration" beta
            # is a constant of the update phase, adapted once in `_update`
            actor_loss, critic_loss, kl_beta, metrics = kl_pen_ppo_loss(
                dist, old_dist, value, inputs, kl_beta, dtarg=cfg.dtarg, increment=cfg.kl_increment,
                decrement=cfg.kl_decrement, adapt=cfg.kl_beta_interval != "iteration", **common,
            )
        else:
            clip_eps = cfg.clip_epsilon
            if cfg.anneal_clip_epsilon:
                clip_eps = cfg.clip_epsilon * (1.0 - num_updates / self.total_network_updates)
            actor_loss, critic_loss, metrics = ppo_clip_loss(
                dist, value, inputs, clip_epsilon=clip_eps, clip_value=cfg.clip_value, **common,
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

    @spanned("train.minibatch")
    def _minibatch_step(self, state: TrainState, mb: Dict, num_updates: int, kl_beta: Optional[torch.Tensor] = None,
                        lr_scale: Optional[float] = None) -> Tuple[Dict[str, torch.Tensor], Optional[torch.Tensor]]:
        """Loss, backward, and one Adam step of actor and critic. Returns the
        metrics and the KL-penalty beta for the next minibatch."""
        state.actor_opt.zero_grad(set_to_none=True)
        state.critic_opt.zero_grad(set_to_none=True)
        with global_batch(self.dp, self.mini_batch_size):
            loss, (metrics, kl_beta) = self._minibatch_loss(mb, num_updates, state.initial_entropy, kl_beta)
            with span("train.backward"):
                loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        if self.dp is not None:
            # each rank's loss is its share of the minibatch mean: the summed
            # gradients and metrics are the global minibatch's
            grads = [p.grad for m in (self.policy, self.critic) for p in m.parameters() if p.grad is not None]
            for g, total in zip(grads, self.dp.all_reduce(grads)):
                g.copy_(total)
            metrics = self._reduce_metrics(metrics)
        # pre-clip gradient magnitude; `_max` aggregates as a max below
        gn = global_norm([p.grad for p in self.policy.parameters() if p.grad is not None])
        metrics["grad_norm_actor"] = metrics["grad_norm_actor_max"] = gn
        with span("train.optimizer"):
            self._optimizer_step(state.actor_opt, num_updates, lr_scale)
            self._optimizer_step(state.critic_opt, num_updates, lr_scale)
        return metrics, kl_beta

    # metrics the losses compute from replicated or already global values
    REPLICATED_METRICS = ("ESS", "kl_penalty_beta")

    def _reduce_metrics(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Per-rank minibatch metrics -> the global minibatch's: `_max` keys
        as maxima, `_min` keys as minima, the shares of means summed."""
        kinds = {"max": [], "min": [], "sum": []}
        for k in metrics:
            if k not in self.REPLICATED_METRICS:
                kinds["max" if k.endswith("_max") else "min" if k.endswith("_min") else "sum"].append(k)
        out = dict(metrics)
        for op, keys in kinds.items():
            out.update(zip(keys, self.dp.all_reduce([metrics[k] for k in keys], op)))
        return out

    def _local_minibatches(self, perm: torch.Tensor) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """This rank's share of each minibatch of a global permutation: global
        sample i is env i % B at step i // B. Per minibatch, the indices of
        the rank's samples into its flattened [T * B_local] data and their
        positions in the global minibatch, both in the minibatch's order."""
        B, rows = self.num_envs, self.rows
        lo, b_local = rows.index.start, rows.index.stop - rows.index.start
        perm = perm.cpu()  # one read per epoch
        env = perm % B
        counts = torch.stack([((env >= r * b_local) & (env < (r + 1) * b_local)).sum(1) for r in range(self.dp.world)])
        if int(counts.min()) == 0:
            raise ValueError(f"a minibatch of {perm.shape[1]} samples left a rank without samples; "
                             f"use larger minibatches or fewer processes")
        out = []
        for row, e in zip(perm, env):
            pos = ((e >= lo) & (e < lo + b_local)).nonzero().squeeze(1)
            idx = (row[pos] // B) * b_local + (e[pos] - lo)
            out.append((idx.to(self.device), pos.to(self.device)))
        return out

    def _global_var(self, x: torch.Tensor) -> torch.Tensor:
        """`x.var(correction=0)` over the samples of every rank."""
        if self.dp is None:
            return x.var(correction=0)
        n = x.numel() * self.dp.world
        mean = self._total(x.sum())[0] / n
        return self._total(((x - mean) ** 2).sum())[0] / n

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
            shares = [(idx, None) for idx in perm] if self.dp is None else self._local_minibatches(perm)
            for idx, pos in shares:
                mb = self._minibatch(data, idx)
                if pos is not None:
                    mb["rows"] = Rows(pos, self.mini_batch_size)
                metrics, kl_beta = self._minibatch_step(state, mb, num_updates, kl_beta, lr_scale)
                for k, v in metrics.items():
                    stacked.setdefault(k, []).append(v)
                num_updates += 1
        if cfg.algo == "kl_ppo" and cfg.kl_beta_interval == "iteration":
            # one adapt step per iteration, from the mean of the LAST epoch's
            # minibatch KLs (each taken before its minibatch's update)
            kl_final = torch.stack(stacked["kl"][-self.num_minibatches:]).mean()
            kl_beta = adapt_kl_beta(kl_beta, kl_final, cfg.dtarg, cfg.kl_increment, cfg.kl_decrement)
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

    # ------------------------------------------------------------------ PAPI

    def papi_init(self, state: TrainState) -> PAPIState:
        """The PAPI carry for `train_iteration_papi`. Raises `find_papi_paths`'s
        ValueError for a policy without a Dense `mean` head and a
        non-contextual std (HEPi and EMPN have no `mean` head)."""
        params = dict(self.policy.named_parameters())
        find_papi_paths(params)
        return papi_init_state(params, history=self.cfg.papi_history)

    def _papi_steps(self, state: TrainState, batch: Batch, papi_state: PAPIState) -> Tuple[PAPIState, Dict[str, torch.Tensor]]:
        """PAPI's post-update steps on the collected batch: the policy's
        parameters are replaced by the projected ones and the LR scale
        decays after a deep backtrack or when nothing is feasible. The
        full-batch forwards (T*B samples, no grad) run 1 + backtracks + 1 +
        papi_iters times."""
        cfg = self.cfg
        T, B = cfg.steps_per_batch, self.env.cfg.num_envs

        def flat(x):
            return x.reshape((T * B,) + x.shape[2:])

        with torch.no_grad():
            graph, feats = self.policy_builder.build({k: flat(v) for k, v in batch.tobs.items()},
                                                     torch.arange(B, device=self.device).repeat(T))
        params = {k: v.detach() for k, v in self.policy.named_parameters()}
        with global_batch(self.dp, T * self.num_envs):  # the expected divergences over every rank's samples
            new_params, papi_state, anneal, n_backtracks = papi_steps(
            lambda p: torch.func.functional_call(self.policy, p, (graph, feats)),
                params, papi_state, G.DiagGaussian(flat(batch.mean), flat(batch.std)),
                mean_bound=self.projection.mean_bound, cov_bound=self.projection.cov_bound,
                initial_entropy=state.initial_entropy, init_std=self.policy.init_std, minimal_std=self.policy.minimal_std,
                n_iters=cfg.papi_iters,
            )
        with torch.no_grad():
            for k, p in self.policy.named_parameters():
                p.copy_(new_params[k])
        papi_state = papi_state._replace(lr_scale=papi_state.lr_scale * (cfg.papi_lr_decay if anneal else 1.0))
        return papi_state, {"papi/n_backtracks": torch.tensor(float(n_backtracks)), "papi/lr_scale": papi_state.lr_scale}

    def train_iteration_papi(self, state: TrainState, papi_state: PAPIState
                             ) -> Tuple[TrainState, PAPIState, Dict[str, torch.Tensor]]:
        """Collect, update with Adam's updates scaled by the PAPI LR scale,
        then `_papi_steps`. Reports each part's seconds (`train/collect_time`,
        `train/update_time`, `train/papi_time`), each ending in a device
        synchronize."""
        self._sync()
        t0 = time.perf_counter()
        state, batch, collect_stats = self._collect(state)
        self._sync()
        t1 = time.perf_counter()
        state, metrics = self._update(state, batch, lr_scale=float(papi_state.lr_scale))
        self._sync()
        t2 = time.perf_counter()
        papi_state, papi_metrics = self._papi_steps(state, batch, papi_state)
        self._sync()
        metrics.update(collect_stats)
        metrics.update(papi_metrics)
        metrics["train/collect_time"] = torch.tensor(t1 - t0)
        metrics["train/update_time"] = torch.tensor(t2 - t1)
        metrics["train/papi_time"] = torch.tensor(time.perf_counter() - t2)
        return state, papi_state, metrics

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
            action = dist.mean if deterministic else G.sample(gen, dist, rows=self.rows)
            env_state, ts = self.env.step(env_state, action)
            yield ts
            obs = ts.obs

    @torch.no_grad()
    def eval_rollout(self, state: TrainState, n_steps: int, deterministic: bool = True) -> torch.Tensor:
        """Deterministic (mode) rollout returning the mean episode reward."""
        cum = torch.zeros(self.env.cfg.num_envs, device=self.device)
        ep_sum = torch.zeros((), device=self.device)
        ep_cnt = torch.zeros((), dtype=torch.int64, device=self.device)
        for ts in self._eval_steps(state, n_steps, deterministic, 7):
            cum = cum + ts.reward
            ep_sum = ep_sum + torch.where(ts.done, cum, 0.0).sum()
            ep_cnt = ep_cnt + ts.done.sum()
            cum = torch.where(ts.done, 0.0, cum)
        ep_sum, ep_cnt = self._total(ep_sum, ep_cnt)
        return ep_sum / torch.clamp(ep_cnt, min=1)

    @torch.no_grad()
    def eval_success(self, state: TrainState, n_steps: int, threshold: float = 0.1, deterministic: bool = True) -> Dict[str, torch.Tensor]:
        """Fraction of episode ends whose final `object_target_distance` is
        under `threshold`, plus the mean final distance."""
        succ = dist_sum = ends = torch.zeros((), device=self.device)
        for ts in self._eval_steps(state, n_steps, deterministic, 13):
            d = ts.info["object_target_distance"]
            done_f = ts.done.to(d.dtype)
            succ = succ + (done_f * (d < threshold)).sum()
            dist_sum = dist_sum + (done_f * d).sum()
            ends = ends + done_f.sum()
        succ, dist_sum, ends = self._total(succ, dist_sum, ends)
        ends = torch.clamp(ends, min=1.0)
        return {"success_rate": succ / ends, "mean_final_distance": dist_sum / ends}
