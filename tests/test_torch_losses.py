"""Clipped PPO and adaptive KL-penalty PPO losses of the PyTorch port against
the JAX package, on the same numpy inputs (f32).

Tolerances: values and metrics within 1e-5 relative and 1e-6 absolute
(means over a batch of 16 summed in another order); gradients within 1e-5 of
each tensor's largest entry (with beta at its 1e6 ceiling the KL term's
gradient is ~1e5 and an entry near 1e2 is a difference of such terms). The
adapted beta is a power-of-two multiple of the input, clamped: it must be
equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (pins torch to one thread per test worker)
from geometry_rl_tpu.rl import gaussian as jax_gaussian
from geometry_rl_tpu.rl import losses as jax_losses
from geometry_rl_torch.rl import gaussian, losses

B, K = 16, 6
RTOL, ATOL = 1e-5, 1e-6


def t(a, requires_grad=False):
    return torch.tensor(np.asarray(a), requires_grad=requires_grad)


def close(got, ref, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got), np.asarray(ref),
                               rtol=RTOL, atol=ATOL, err_msg=msg)


def close_to_scale(got, ref, msg=""):
    ref = np.asarray(ref)
    err = np.abs(got.detach().numpy() - ref).max()
    assert err <= RTOL * np.abs(ref).max() + ATOL, (msg, err, np.abs(ref).max())


def loss_inputs(seed=7, spread=0.3):
    """A new and an old distribution `spread` apart, actions drawn from the
    old one, its log-probabilities, and advantages, value targets, old and
    new values."""
    rng = np.random.default_rng(seed)
    old_mean = rng.normal(size=(B, K)).astype(np.float32)
    old_std = np.exp(rng.normal(scale=0.3, size=(B, K))).astype(np.float32)
    mean = (old_mean + spread * rng.normal(size=(B, K))).astype(np.float32)
    std = (old_std * np.exp(spread * rng.normal(size=(B, K)))).astype(np.float32)
    action = (old_mean + old_std * rng.normal(size=(B, K))).astype(np.float32)
    sample_lp = np.asarray(jax_gaussian.log_prob(jax_gaussian.DiagGaussian(old_mean, old_std), action))
    adv, vt, old_v, value = rng.normal(size=(4, B)).astype(np.float32)
    return mean, std, old_mean, old_std, value, (action, sample_lp, adv, vt, old_v)


@pytest.mark.parametrize("clip_value,loss_critic_type,normalize,entropy_bonus", [
    (0.2, "l2", True, True), (None, "smooth_l1", False, True), (0.5, "l1", True, False),
])
def test_ppo_clip_loss_matches_reference(clip_value, loss_critic_type, normalize, entropy_bonus):
    mean, std, _, _, value, inp = loss_inputs(spread=0.3)
    kw = dict(clip_epsilon=0.2, entropy_coef=0.005, critic_coef=0.5, clip_value=clip_value,
              loss_critic_type=loss_critic_type, normalize_advantage=normalize, entropy_bonus=entropy_bonus)

    def jax_loss(m, s, v):
        a, c, metrics = jax_losses.ppo_clip_loss(jax_gaussian.DiagGaussian(m, s), v, jax_losses.LossInputs(*inp), **kw)
        return a + c, (a, c, metrics)

    (_, (ja, jc, jm)), jgrads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(mean), jnp.asarray(std), jnp.asarray(value))
    m, s, v = t(mean, True), t(std, True), t(value, True)
    ta, tc, tm = losses.ppo_clip_loss(gaussian.DiagGaussian(m, s), v, losses.LossInputs(*map(t, inp)), **kw)
    (ta + tc).backward()
    close(ta, ja, "actor_loss")
    close(tc, jc, "critic_loss")
    assert sorted(tm) == sorted(jm)
    for k in jm:
        close(tm[k], jm[k], k)
    assert 0.0 < tm["clip_fraction"].item() < 1.0  # both branches of the clip are taken
    for got, ref, name in zip((m.grad, s.grad, v.grad), jgrads, ("mean", "std", "value")):
        close_to_scale(got, ref, f"d/d{name}")


# (beta in, spread of the new policy, dtarg, expected factor): the batch KL
# is 0.94 at spread 0.3 and 8.4e-3 at spread 0.03
BETA_CASES = {
    "increase": (1.0, 0.3, 0.01, 2.0),
    "decrease": (1.0, 0.03, 0.1, 0.5),
    "hold": (1.0, 0.3, 1.0, 1.0),
    "ceiling": (1e6, 0.3, 0.01, 1.0),
    "floor": (1e-2, 0.03, 0.1, 1.0),
}


@pytest.mark.parametrize("adapt", [True, False], ids=["minibatch", "iteration"])
@pytest.mark.parametrize("case", sorted(BETA_CASES))
def test_kl_pen_ppo_loss_matches_reference(case, adapt):
    """Loss values, metrics, gradients and the adapted beta: up or down by
    its factor outside the band, held inside it, and clamped at both ends;
    with adapt=False (kl_beta_interval "iteration") beta is held."""
    beta, spread, dtarg, factor = BETA_CASES[case]
    mean, std, old_mean, old_std, value, inp = loss_inputs(spread=spread)
    kw = dict(dtarg=dtarg, increment=2.0, decrement=0.5, entropy_coef=0.01, critic_coef=1.0, adapt=adapt,
              entropy_bonus=case == "hold", clip_value=0.2 if case == "ceiling" else None)

    def jax_loss(m, s, v):
        a, c, nb, metrics = jax_losses.kl_pen_ppo_loss(
            jax_gaussian.DiagGaussian(m, s), jax_gaussian.DiagGaussian(old_mean, old_std), v,
            jax_losses.LossInputs(*inp), jnp.float32(beta), **kw)
        return a + c, (a, c, nb, metrics)

    (_, (ja, jc, jbeta, jm)), jgrads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(mean), jnp.asarray(std), jnp.asarray(value))
    m, s, v = t(mean, True), t(std, True), t(value, True)
    ta, tc, tbeta, tm = losses.kl_pen_ppo_loss(
        gaussian.DiagGaussian(m, s), gaussian.DiagGaussian(t(old_mean), t(old_std)), v,
        losses.LossInputs(*map(t, inp)), torch.tensor(beta, dtype=torch.float32), **kw)
    (ta + tc).backward()
    close(ta, ja, "actor_loss")
    close(tc, jc, "critic_loss")
    assert sorted(tm) == sorted(jm)
    for k in jm:
        close(tm[k], jm[k], k)
    for got, ref, name in zip((m.grad, s.grad, v.grad), jgrads, ("mean", "std", "value")):
        close_to_scale(got, ref, f"d/d{name}")
    assert tbeta.item() == float(jbeta) == np.float32(beta * (factor if adapt else 1.0))
    assert not tbeta.requires_grad


def test_adapt_kl_beta_clamps_to_the_band():
    beta = torch.tensor([1e-2, 1.0, 1e6, 3.0])
    kl = torch.tensor([0.0, 1.0, 1.0, 0.01])
    got = losses.adapt_kl_beta(beta, kl, 0.01, 2.0, 0.5)
    assert got.tolist() == np.float32([losses.KL_PEN_BETA_MIN, 2.0, losses.KL_PEN_BETA_MAX, 3.0]).tolist()
    assert (losses.KL_PEN_BETA_MIN, losses.KL_PEN_BETA_MAX) == (jax_losses.KL_PEN_BETA_MIN, jax_losses.KL_PEN_BETA_MAX)
