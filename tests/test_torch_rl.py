"""Small modules of the port's slice against the JAX package on numpy inputs:
quaternion math, the observation normaliser and pipeline, and the diagonal
Gaussian. All f32; tolerances at a few ulps of the values compared."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import test_torch_common  # noqa: F401  (pins torch to one thread per test worker)

from geometry_rl_tpu.rl import gaussian as jax_gaussian
from geometry_rl_tpu.rl.obs_pipeline import obs_norm_init as jax_norm_init, obs_norm_step as jax_norm_step
from geometry_rl_tpu.utils import math as jax_math
from geometry_rl_torch.convert import obs_norm_from_jax
from geometry_rl_torch.rl import gaussian
from geometry_rl_torch.rl.obs_pipeline import obs_norm_init, obs_norm_step
from geometry_rl_torch.utils import math as tmath


def t(a):
    return torch.as_tensor(np.asarray(a))


def test_quaternions_match():
    rng = np.random.default_rng(0)
    r, p, y = rng.uniform(-3, 3, (3, 5)).astype(np.float32)
    q_ref = jax_math.quat_from_euler_xyz(jnp.asarray(r), jnp.asarray(p), jnp.asarray(y))
    q = tmath.quat_from_euler_xyz(t(r), t(p), t(y))
    np.testing.assert_allclose(q.numpy(), np.asarray(q_ref), atol=1e-6)
    v = rng.normal(size=(5, 4, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tmath.quat_apply(q[:, None, :], t(v)).numpy(), np.asarray(jax_math.quat_apply(q_ref[:, None, :], jnp.asarray(v))), atol=1e-5
    )
    np.testing.assert_allclose(tmath.quat_mul(q, q.flip(0)).numpy(), np.asarray(jax_math.quat_mul(q_ref, q_ref[::-1])), atol=1e-6)
    np.testing.assert_array_equal(tmath.quat_identity((2,)).numpy(), np.asarray(jax_math.quat_identity((2,))))


def test_obs_pipeline_matches():
    rng = np.random.default_rng(1)
    dims = {"scalars": 7, "position_vectors": 12, "velocity_vectors": 6, "infos": 2}
    jstate, tstate = jax_norm_init(dims["scalars"]), obs_norm_init(dims["scalars"])
    for k in range(3):
        obs = {g: (rng.normal(size=(4, d)) * (k + 1) * 10).astype(np.float32) for g, d in dims.items()}
        jstate, jt = jax_norm_step(jstate, {g: jnp.asarray(v) for g, v in obs.items()}, update=k < 2)
        tstate, tt = obs_norm_step(tstate, {g: t(v) for g, v in obs.items()}, update=k < 2)
        for g, ref in jt.items():
            np.testing.assert_allclose(tt[g].numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5, err_msg=g)
    for a, b in zip(obs_norm_from_jax(jstate), tstate):
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("k", [1, 12])
def test_diag_gaussian_matches(k):
    rng = np.random.default_rng(k)
    mean, x = rng.normal(size=(2, 5, k)).astype(np.float32)
    std = rng.uniform(0.1, 2.0, (5, k)).astype(np.float32)
    jd, td = jax_gaussian.DiagGaussian(jnp.asarray(mean), jnp.asarray(std)), gaussian.DiagGaussian(t(mean), t(std))
    np.testing.assert_allclose(gaussian.log_prob(td, t(x)).numpy(), np.asarray(jax_gaussian.log_prob(jd, jnp.asarray(x))), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(gaussian.entropy(td).numpy(), np.asarray(jax_gaussian.entropy(jd)), rtol=1e-6, atol=1e-5)
    draws = gaussian.sample(torch.Generator().manual_seed(0), td, (20000,))
    assert draws.shape == (20000, 5, k)
    # sample mean within 6 standard errors, sample std within 5% (~7 s.e.)
    assert ((draws.mean(0) - td.mean).abs() <= 6 * td.std / 20000**0.5).all()
    torch.testing.assert_close(draws.std(0), td.std, rtol=0.05, atol=0)
