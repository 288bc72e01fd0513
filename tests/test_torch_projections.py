"""GAE, the KL projection, the projection layers (KL, Frobenius, W2, PAPI)
and the TRPL loss of the PyTorch port against the JAX package, on the same
numpy inputs (f32).

Tolerances:
- GAE: 1e-6 absolute (a sum of ~T terms of order 1, f32).
- KL covariance projection forward and VJP: 1e-5 relative. Both bisect in
  the same order; the bracket converges to the same f32 point, so they differ
  by the ulps of the interpolation and of the closed-form backward.
- Layers, losses, metrics and their gradients: 1e-5 relative, 1e-6 absolute
  (sums over a batch of 16 in another order). The Frobenius, W2 and PAPI
  layers' gradients: within 1e-5 of each tensor's largest entry (the W2
  cov part with `scale_prec` is 1 + c - 2 sqrt(c) per entry, a cancellation
  that leaves the small entries a few ulps of the large ones).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import test_torch_common  # noqa: F401  (pins torch to one thread per test worker)

from geometry_rl_tpu.rl import gaussian as jax_gaussian
from geometry_rl_tpu.rl.gae import gae as jax_gae
from geometry_rl_tpu.rl.losses import LossInputs as JaxLossInputs, trpl_loss as jax_trpl_loss
from geometry_rl_tpu.rl.projections import (
    get_projection_layer as jax_get_projection_layer,
    kl_diag_cov_projection as jax_kl_diag_cov_projection,
)
from geometry_rl_torch.rl import gaussian
from geometry_rl_torch.rl.gae import gae
from geometry_rl_torch.rl.losses import LossInputs, trpl_loss
from geometry_rl_torch.rl.projections import (
    BaseProjection,
    KLProjection,
    entropy_equality_projection,
    entropy_inequality_projection,
    get_projection_layer,
    kl_diag_cov_projection,
    mean_projection,
)

B, K = 16, 6
RTOL, ATOL = 1e-5, 1e-6


def t(a, requires_grad=False):
    return torch.tensor(np.asarray(a), requires_grad=requires_grad)


def close(got, ref, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got), np.asarray(ref),
                               rtol=rtol, atol=atol, err_msg=msg)


def dist_arrays(seed=42, cov_scale=1.0):
    rng = np.random.default_rng(seed)
    mean = rng.normal(size=(B, K)).astype(np.float32)
    std = (np.exp(rng.normal(scale=0.3, size=(B, K))) * cov_scale).astype(np.float32)
    old_mean = mean + 0.1 * rng.normal(size=(B, K)).astype(np.float32)
    old_std = np.exp(rng.normal(scale=0.3, size=(B, K))).astype(np.float32)
    return mean, std, old_mean, old_std


def test_gae_matches_reference():
    rng = np.random.default_rng(0)
    T, E = 7, 5
    rewards = rng.normal(size=(T, E)).astype(np.float32)
    values = rng.normal(size=(T, E)).astype(np.float32)
    dones = rng.uniform(size=(T, E)) < 0.2
    boot = rng.normal(size=(E,)).astype(np.float32)
    ref = jax_gae(jnp.asarray(rewards), jnp.asarray(values), jnp.asarray(dones), jnp.asarray(boot), 0.99, 0.95)
    got = gae(t(rewards), t(values), t(dones), t(boot), 0.99, 0.95)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6)


def test_kl_parts_match_reference():
    mean, std, old_mean, old_std = dist_arrays()
    ref = jax_gaussian.kl_parts(jax_gaussian.DiagGaussian(mean, std), jax_gaussian.DiagGaussian(old_mean, old_std))
    got = gaussian.kl_parts(gaussian.DiagGaussian(t(mean), t(std)), gaussian.DiagGaussian(t(old_mean), t(old_std)))
    for g, r in zip(got, ref):
        close(g, r)
    close(gaussian.kl(gaussian.DiagGaussian(t(mean), t(std)), gaussian.DiagGaussian(t(old_mean), t(old_std))),
          ref[0] + ref[1])


def projection_inputs():
    """Variances with active rows (3x the std), inactive rows (old variance
    within 1e-4) and one non-finite row."""
    _, std, _, old_std = dist_arrays()
    var = (std * 3.0) ** 2
    old_var = old_std**2
    var[4:8] = old_var[4:8] * 1.0001  # inside the ball
    var[9, 2] = np.nan  # the solve goes non-finite: fallback to old_var
    return var.astype(np.float32), old_var.astype(np.float32)


@pytest.mark.parametrize("eps_kind", ["scalar", "per_row"])
def test_kl_cov_projection_forward_and_vjp_match_reference(eps_kind):
    var, old_var = projection_inputs()
    eps = 2.5e-3 if eps_kind == "scalar" else np.linspace(1e-3, 5e-3, B).astype(np.float32)
    g = np.random.default_rng(3).normal(size=var.shape).astype(np.float32)

    ref, vjp = jax.vjp(lambda v: jax_kl_diag_cov_projection(v, jnp.asarray(old_var), eps), jnp.asarray(var))
    (ref_grad,) = vjp(jnp.asarray(g))

    v = t(var, requires_grad=True)
    out = kl_diag_cov_projection(v, t(old_var), eps if eps_kind == "scalar" else t(eps))
    out.backward(t(g))
    close(out, ref, rtol=1e-5, atol=0)
    close(v.grad, ref_grad, rtol=1e-5, atol=1e-6)
    # each row kind is present: projected, identity, fallback
    assert not np.allclose(np.asarray(ref)[0], var[0])
    np.testing.assert_allclose(out[4:8].detach().numpy(), var[4:8], rtol=1e-6)  # 1 / (1 / v)
    np.testing.assert_array_equal(out[9].detach().numpy(), old_var[9])
    np.testing.assert_array_equal(v.grad[4:8].numpy(), g[4:8])
    assert (v.grad[9] == 0).all()


def test_kl_cov_projection_gradcheck_float64():
    """The implicit-function backward against finite differences in f64, on
    active and inactive rows (the reference's check at test_projections.py:168
    does three entries in f32)."""
    _, std, _, old_std = dist_arrays()
    var = torch.tensor((std.astype(np.float64) * 3.0) ** 2, requires_grad=True)
    old_var = torch.tensor(old_std.astype(np.float64) ** 2)
    with torch.no_grad():
        var[4:8] = old_var[4:8] * 1.0001
    assert torch.autograd.gradcheck(lambda v: kl_diag_cov_projection(v, old_var, 2.5e-3), (var,), eps=1e-6, atol=1e-5)


def test_kl_cov_projection_no_gradient_to_old_var():
    var, old_var = projection_inputs()
    v = t(var, requires_grad=True)
    ov = t(old_var, requires_grad=True)
    kl_diag_cov_projection(v, ov, 2.5e-3).sum().backward()
    assert ov.grad is None and v.grad is not None


SCHEDULES = {
    "none": dict(),
    "linear": dict(entropy_schedule_type="linear", total_train_steps=100, target_entropy=-1.0),
    "exp": dict(entropy_schedule_type="exp", total_train_steps=100, target_entropy=-0.5, temperature=0.5),
}


@pytest.mark.parametrize("entropy_first", [False, True])
@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_kl_projection_layer_matches_reference(schedule, entropy_first):
    mean, std, old_mean, old_std = dist_arrays(cov_scale=2.0)
    kw = dict(mean_bound=0.05, cov_bound=1e-3, trust_region_coeff=4.0, action_dim=K, entropy_first=entropy_first,
              **SCHEDULES[schedule])
    e0 = np.float32(9.0)
    jl, tl = jax_get_projection_layer("kl", **kw), get_projection_layer("kl", **kw)
    assert isinstance(tl, KLProjection)
    jp, jq = jax_gaussian.DiagGaussian(jnp.asarray(mean), jnp.asarray(std)), jax_gaussian.DiagGaussian(old_mean, old_std)

    def jax_fn(m, s):
        p = jax_gaussian.DiagGaussian(m, s)
        proj = jl(p, jq, 37, initial_entropy=jnp.asarray(e0))
        return proj, jl.trust_region_loss(p, proj)

    (jproj, jloss), vjp = jax.vjp(jax_fn, jp.mean, jp.std)
    jgrads = vjp((jax_gaussian.DiagGaussian(jnp.ones_like(jproj.mean), jnp.ones_like(jproj.std)), jnp.ones(())))

    m, s = t(mean, requires_grad=True), t(std, requires_grad=True)
    tp = gaussian.DiagGaussian(m, s)
    tproj = tl(tp, gaussian.DiagGaussian(t(old_mean), t(old_std)), 37, initial_entropy=t(e0))
    tloss = tl.trust_region_loss(tp, tproj)
    (tproj.mean.sum() + tproj.std.sum() + tloss).backward()

    close(tproj.mean, jproj.mean, msg="mean")
    close(tproj.std, jproj.std, msg="std")
    close(tloss, jloss, msg="trust_region_loss")
    close(m.grad, jgrads[0], msg="d/dmean")
    close(s.grad, jgrads[1], msg="d/dstd")
    jm, tm = jl.compute_metrics(jp, jproj), tl.compute_metrics(gaussian.DiagGaussian(t(mean), t(std)), tproj)
    assert sorted(jm) == sorted(tm)
    for k in jm:
        close(tm[k], jm[k], rtol=1e-5, atol=1e-6, msg=k)


def test_closed_form_projections_match_reference():
    from geometry_rl_tpu.rl.projections import (
        entropy_equality_projection as j_eq,
        entropy_inequality_projection as j_ineq,
        mean_projection as j_mean,
    )

    mean, std, old_mean, old_std = dist_arrays()
    maha = 0.5 * (((mean - old_mean) / old_std) ** 2).sum(-1)
    close(mean_projection(t(mean), t(old_mean), t(maha), 0.05), j_mean(mean, old_mean, maha, 0.05))
    for jf, tf in ((j_ineq, entropy_inequality_projection), (j_eq, entropy_equality_projection)):
        r = jf(jax_gaussian.DiagGaussian(mean, std), 1.0)
        g = tf(gaussian.DiagGaussian(t(mean), t(std)), torch.tensor(1.0))
        close(g.std, r.std)
        close(g.mean, r.mean)


def test_projection_factory():
    """Every name the reference's factory takes gives the same layer type,
    and PAPI's layer projects its entropy first."""
    assert type(get_projection_layer("ppo")) is BaseProjection
    p = gaussian.DiagGaussian(torch.zeros(2, 3), torch.ones(2, 3))
    assert all(torch.equal(a, b) for a, b in zip(get_projection_layer("identity")(p, p), p))
    for name in ("kl", "frob", "w2", "wasserstein", "w2_non_com", "papi", "ppo", "", "identity", "entropy", "none"):
        assert type(get_projection_layer(name)).__name__ == type(jax_get_projection_layer(name)).__name__, name
    assert get_projection_layer("papi").entropy_first and not get_projection_layer("papi", entropy_first=False).entropy_first
    with pytest.raises(ValueError):
        get_projection_layer("nope")


@pytest.mark.parametrize("scale_prec", [True, False])
def test_frobenius_and_wasserstein_parts_match_reference(scale_prec):
    mean, std, old_mean, old_std = dist_arrays()
    jp, jq = jax_gaussian.DiagGaussian(mean, std), jax_gaussian.DiagGaussian(old_mean, old_std)
    tp, tq = gaussian.DiagGaussian(t(mean), t(std)), gaussian.DiagGaussian(t(old_mean), t(old_std))
    for name in ("frobenius_parts", "wasserstein_parts"):
        ref = getattr(jax_gaussian, name)(jp, jq, scale_prec=scale_prec)
        got = getattr(gaussian, name)(tp, tq, scale_prec=scale_prec)
        for g, r, part in zip(got, ref, ("mean", "cov")):
            close(g, r, msg=f"{name} {part}")


@pytest.mark.parametrize("scale_prec", [True, False])
@pytest.mark.parametrize("proj_type", ["frob", "w2", "papi"])
def test_frobenius_w2_and_papi_layers_match_reference(proj_type, scale_prec):
    """Projected distribution, `trust_region_loss` and the gradients of both
    (against `jax.vjp`), and the constraint metrics; the covariance bound is
    active on some rows and not on others."""
    mean, std, old_mean, old_std = dist_arrays(cov_scale=1.2)
    std[4:8] = old_std[4:8] * 1.001  # inside the covariance bound
    kw = dict(mean_bound=0.05, cov_bound=0.05, trust_region_coeff=4.0, action_dim=K, scale_prec=scale_prec)
    jl, tl = jax_get_projection_layer(proj_type, **kw), get_projection_layer(proj_type, **kw)
    jq = jax_gaussian.DiagGaussian(old_mean, old_std)

    def jax_fn(m, s):
        p = jax_gaussian.DiagGaussian(m, s)
        proj = jl(p, jq, 5)
        return proj, jl.trust_region_loss(p, proj)

    (jproj, jloss), vjp = jax.vjp(jax_fn, jnp.asarray(mean), jnp.asarray(std))
    jgrads = vjp((jax_gaussian.DiagGaussian(jnp.ones_like(jproj.mean), jnp.ones_like(jproj.std)), jnp.ones(())))

    m, s = t(mean, requires_grad=True), t(std, requires_grad=True)
    tp = gaussian.DiagGaussian(m, s)
    tproj = tl(tp, gaussian.DiagGaussian(t(old_mean), t(old_std)), 5)
    tloss = tl.trust_region_loss(tp, tproj)
    (tproj.mean.sum() + tproj.std.sum() + tloss).backward()
    close(tproj.mean, jproj.mean, msg="mean")
    close(tproj.std, jproj.std, msg="std")
    close(tloss, jloss, msg="trust_region_loss")
    for got, ref, name in ((m.grad, jgrads[0], "d/dmean"), (s.grad, jgrads[1], "d/dstd")):
        ref = np.asarray(ref)
        assert np.abs(got.numpy() - ref).max() <= RTOL * np.abs(ref).max(), name
    if proj_type != "papi":  # some rows projected, some not
        cov_part = np.asarray(jl.trust_region_value(jax_gaussian.DiagGaussian(mean, std), jq)[1])
        assert (cov_part > 0.05).any() and (cov_part <= 0.05).any()
    jm = jl.compute_metrics(jax_gaussian.DiagGaussian(mean, std), jproj)
    tm = tl.compute_metrics(gaussian.DiagGaussian(t(mean), t(std)), tproj)
    assert sorted(jm) == sorted(tm)
    for k in jm:
        close(tm[k], jm[k], msg=k)


@pytest.mark.parametrize("loss_critic_type,normalize", [("l2", True), ("smooth_l1", False)])
def test_trpl_loss_matches_reference(loss_critic_type, normalize):
    mean, std, old_mean, old_std = dist_arrays(cov_scale=1.5)
    rng = np.random.default_rng(7)
    action = (old_mean + old_std * rng.normal(size=(B, K))).astype(np.float32)
    sample_lp = np.asarray(jax_gaussian.log_prob(jax_gaussian.DiagGaussian(old_mean, old_std), action))
    adv, vt, old_v, value = rng.normal(size=(4, B)).astype(np.float32)
    kw = dict(entropy_coef=0.005, critic_coef=0.5, clip_value=0.2, loss_critic_type=loss_critic_type,
              normalize_advantage=normalize, entropy_bonus=True)
    proj_kw = dict(mean_bound=0.05, cov_bound=1e-3, trust_region_coeff=4.0, action_dim=K,
                   entropy_schedule_type="linear", total_train_steps=50, target_entropy=-2.0)
    jproj, tproj = jax_get_projection_layer("kl", **proj_kw), get_projection_layer("kl", **proj_kw)
    e0 = np.float32(8.0)

    def jax_loss(m, s, v):
        a, c, metrics = jax_trpl_loss(
            jax_gaussian.DiagGaussian(m, s), jax_gaussian.DiagGaussian(old_mean, old_std), v,
            JaxLossInputs(action, sample_lp, adv, vt, old_v), jproj, step=11, initial_entropy=jnp.asarray(e0), **kw,
        )
        return a + c, (a, c, metrics)

    (_, (ja, jc, jm)), jgrads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(mean), jnp.asarray(std), jnp.asarray(value)
    )
    m, s, v = t(mean, True), t(std, True), t(value, True)
    ta, tc, tm = trpl_loss(
        gaussian.DiagGaussian(m, s), gaussian.DiagGaussian(t(old_mean), t(old_std)), v,
        LossInputs(t(action), t(sample_lp), t(adv), t(vt), t(old_v)), tproj, step=11, initial_entropy=t(e0), **kw,
    )
    (ta + tc).backward()
    close(ta, ja, msg="actor_loss")
    close(tc, jc, msg="critic_loss")
    assert sorted(tm) == sorted(jm)
    for k in jm:
        close(tm[k], jm[k], msg=k)
    for got, ref, name in zip((m.grad, s.grad, v.grad), jgrads, ("mean", "std", "value")):
        close(got, ref, msg=f"d/d{name}")
