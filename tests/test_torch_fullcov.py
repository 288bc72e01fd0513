"""The full-covariance projections of the PyTorch port against the JAX
package (`rl/projections/fullcov.py`), on seeded SPD batches of the tasks'
action widths (k = 6 one gripper, 12 two or four grippers), f32.

Values and gradients (the gradients of the bisected projections through
`lax.custom_root` on the JAX side, `_ImplicitRoot` in the port) are held
within TOL of max(1, each output's largest entry): the W2 cov parts (~0.1)
are differences of traces ~k, so their rounding is absolute, ~1e-6 at k = 12.
Both sides factorise and invert
the k x k matrices with another LAPACK in another order, so every constraint
evaluation differs by a few ulps; the 60-round bisection then stops at
brackets up to ~1e-6 relative apart, and the implicit gradient divides by
the constraint's derivative in eta.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (pins torch to one thread per test worker)
from geometry_rl_tpu.rl.projections import fullcov as jfc
from geometry_rl_torch.rl.projections import fullcov

B = 8
TOL = 2e-5  # observed: up to 7.6e-6


def spd_batch(k, seed):
    """(mean, cov, old_mean, old_cov, sqrt, old_sqrt) [B, ...]: random SPD
    covariances around old ones, rows 0-1 within 1e-4 of them (inactive
    under every bound below), and their symmetric square roots."""
    rng = np.random.default_rng(seed)

    def spd(scale):
        a = rng.normal(size=(B, k, k)) * scale
        return a @ a.transpose(0, 2, 1) / k + 0.5 * np.eye(k)

    old_cov = spd(1.0)
    cov = old_cov + spd(0.3) - 0.5 * np.eye(k) + 0.05 * np.eye(k)
    cov[:2] = old_cov[:2] * (1 + 1e-4)
    old_mean = rng.normal(size=(B, k))
    mean = old_mean + 0.3 * rng.normal(size=(B, k))
    mean[:2] = old_mean[:2] + 1e-4

    def sqrtm(c):
        vals, vecs = np.linalg.eigh(c)
        return vecs @ (np.sqrt(vals)[..., None] * vecs.transpose(0, 2, 1))

    return tuple(np.asarray(x, np.float32) for x in (mean, cov, old_mean, old_cov, sqrtm(cov), sqrtm(old_cov)))


def assert_close(got, ref, what):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert np.isfinite(got).all() and np.isfinite(ref).all(), what
    err, scale = np.abs(got - ref).max(), max(np.abs(ref).max(), 1.0)
    assert err <= TOL * scale, (what, err, scale)


def compare(jax_fn, torch_fn, inputs, argnums, seed=0):
    """Outputs of both functions on `inputs`, and the gradients with respect
    to `inputs[argnums]` of a seeded random linear function of the outputs
    (`jax.vjp` against `backward`)."""
    j_in = [jnp.asarray(x) for x in inputs]
    # jitted: op by op, the CPU compiles every primitive apart
    out, vjp = jax.vjp(jax.jit(lambda *diff: jax_fn(*[diff[argnums.index(i)] if i in argnums else x
                                                      for i, x in enumerate(j_in)])), *[j_in[i] for i in argnums])
    outs = out if isinstance(out, tuple) else (out,)
    rng = np.random.default_rng(seed)
    cts = tuple(rng.normal(size=o.shape).astype(np.float32) for o in outs)
    j_grads = vjp(cts if isinstance(out, tuple) else cts[0])

    t_in = [torch.tensor(x, requires_grad=i in argnums) for i, x in enumerate(inputs)]
    t_out = torch_fn(*t_in)
    t_outs = t_out if isinstance(t_out, tuple) else (t_out,)
    sum((o * torch.tensor(c)).sum() for o, c in zip(t_outs, cts)).backward()
    for i, (g, r) in enumerate(zip(t_outs, outs)):
        assert_close(g, r, f"output {i}")
    for i, r in zip(argnums, j_grads):
        assert_close(t_in[i].grad, r, f"d/d input {i}")
    return [o.detach().numpy() for o in t_outs], t_in


@pytest.mark.parametrize("k", [6, 12])
def test_kl_cov_part_full_matches_reference(k):
    _, cov, _, old_cov, _, _ = spd_batch(k, 1)
    compare(jfc.kl_cov_part_full, fullcov.kl_cov_part_full, (cov, old_cov), argnums=(0,))


@pytest.mark.parametrize("k", [6, 12])
def test_kl_full_cov_projection_matches_reference(k):
    """Active rows go to the bound, the inactive ones pass through with an
    identity gradient, and `old_cov` gets no gradient."""
    _, cov, _, old_cov, _, _ = spd_batch(k, 2)
    eps = 0.02
    (proj,), t_in = compare(lambda c, o: jfc.kl_full_cov_projection(c, o, eps),
                            lambda c, o: fullcov.kl_full_cov_projection(c, o, eps), (cov, old_cov), argnums=(0,))
    c0 = fullcov.kl_cov_part_full(torch.tensor(cov), torch.tensor(old_cov))
    active = c0 > eps
    assert 3 <= active.sum() < B and not active[:2].any()
    kl = fullcov.kl_cov_part_full(torch.tensor(proj), torch.tensor(old_cov))
    assert torch.allclose(kl[active], torch.tensor(eps), rtol=1e-3)
    np.testing.assert_array_equal(proj[~active.numpy()], cov[~active.numpy()])
    o = torch.tensor(old_cov, requires_grad=True)
    fullcov.kl_full_cov_projection(torch.tensor(cov, requires_grad=True), o, eps).sum().backward()
    assert o.grad is None


def test_kl_full_cov_projection_passes_a_non_positive_definite_row_through():
    """A covariance that is not positive definite has no Cholesky factor:
    its KL is NaN, so the row is not active and passes through unchanged,
    in the reference (NaN factors) and in the port (`cholesky_ex`) alike;
    the other rows are unaffected."""
    _, cov, _, old_cov, _, _ = spd_batch(6, 3)
    cov[5] = -np.eye(6, dtype=np.float32)
    ref = np.asarray(jfc.kl_full_cov_projection(jnp.asarray(cov), jnp.asarray(old_cov), 0.02))
    got = fullcov.kl_full_cov_projection(torch.tensor(cov), torch.tensor(old_cov), 0.02).numpy()
    np.testing.assert_array_equal(ref[5], cov[5])
    np.testing.assert_array_equal(got[5], cov[5])
    assert np.isnan(fullcov.kl_cov_part_full(torch.tensor(cov), torch.tensor(old_cov))[5])
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()


@pytest.mark.parametrize("k", [6, 12])
def test_kl_full_parts_and_joint_projection_match_reference(k):
    mean, cov, old_mean, old_cov, _, _ = spd_batch(k, 4)
    compare(jfc.kl_full_parts, fullcov.kl_full_parts, (mean, cov, old_mean, old_cov), argnums=(0, 1))
    eps = 0.1
    (pm, pc), _ = compare(lambda *a: jfc.kl_full_joint_projection(*a, eps),
                          lambda *a: fullcov.kl_full_joint_projection(*a, eps),
                          (mean, cov, old_mean, old_cov), argnums=(0, 1))
    m0, c0 = fullcov.kl_full_parts(*(torch.tensor(x) for x in (mean, cov, old_mean, old_cov)))
    active = m0 + c0 > eps
    assert 3 <= active.sum() < B and not active[:2].any()
    m, c = fullcov.kl_full_parts(*(torch.tensor(x) for x in (pm, pc, old_mean, old_cov)))
    assert torch.allclose((m + c)[active], torch.tensor(eps), rtol=1e-3)
    np.testing.assert_array_equal(pm[~active.numpy()], mean[~active.numpy()])


@pytest.mark.parametrize("scale_prec", [False, True])
@pytest.mark.parametrize("k", [6, 12])
def test_w2_non_commutative_matches_reference(k, scale_prec):
    mean, _, old_mean, _, sqrt, old_sqrt = spd_batch(k, 5)
    args = (mean, sqrt, old_mean, old_sqrt)
    compare(lambda *a: jfc.w2_non_commutative_parts(*a, scale_prec=scale_prec),
            lambda *a: fullcov.w2_non_commutative_parts(*a, scale_prec=scale_prec), args, argnums=(0, 1))
    eps = 0.2
    compare(lambda *a: jfc.w2_non_commutative_projection(*a, eps, scale_prec=scale_prec),
            lambda *a: fullcov.w2_non_commutative_projection(*a, eps, scale_prec=scale_prec), args, argnums=(0, 1))


@pytest.mark.parametrize("k", [6, 12])
def test_full_covariance_layers_match_reference(k):
    mean, cov, old_mean, old_cov, sqrt, old_sqrt = spd_batch(k, 6)
    kw = dict(mean_bound=0.05, cov_bound=0.05)
    compare(jfc.FullCovKLProjection(**kw), fullcov.FullCovKLProjection(**kw), (mean, cov, old_mean, old_cov),
            argnums=(0, 1))
    compare(jfc.FullCovW2NonCommutingProjection(**kw), fullcov.FullCovW2NonCommutingProjection(**kw),
            (mean, sqrt, old_mean, old_sqrt), argnums=(0, 1))
