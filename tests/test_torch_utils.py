"""The port's tensor utilities and the quaternion / transform / grid functions
of `utils/math.py` against the JAX package on seeded numpy inputs.

Tolerances: 1e-6 relative to max(1, scale) for elementwise functions (f32
ops in another order); `sqrtm_newton` 1e-5, its 20 matrix-product rounds
accumulate rounding; `sqrtm_eig` 1e-4, the two eigensolvers round
differently on the small eigenvalues; index functions exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import test_torch_common  # noqa: F401  (pins torch to one thread per test worker)

from geometry_rl_tpu.utils import math as jm
from geometry_rl_tpu.utils import tensor as jt
from geometry_rl_torch.utils import math as tm
from geometry_rl_torch.utils import tensor as tt
from test_torch_common import close

TOL = 1e-6


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _psd(rng, b, d):
    a = rng.normal(size=(b, d, d)).astype(np.float32)
    return a @ a.transpose(0, 2, 1) / d + 0.1 * np.eye(d, dtype=np.float32)


def _quat(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


@pytest.mark.parametrize("name,tol", [("batched_trace", TOL), ("batched_trace_square", TOL), ("sqrtm_newton", 1e-5),
                                      ("sqrtm_eig", 1e-4)])
def test_matrix_functions_match_reference(name, tol):
    m = _psd(np.random.default_rng(0), 6, 5)
    assert close(getattr(tt, name)(_t(m)).numpy(), jax.jit(getattr(jt, name))(jnp.asarray(m)), tol)


@pytest.mark.parametrize("upper", [False, True])
def test_fill_triangular_matches_reference(upper):
    x = np.random.default_rng(1).normal(size=(3, 7, 10)).astype(np.float32)
    mat = tt.fill_triangular(_t(x), upper=upper)
    np.testing.assert_array_equal(mat.numpy(), np.asarray(jt.fill_triangular(jnp.asarray(x), upper=upper)))
    np.testing.assert_array_equal(tt.fill_triangular_inverse(mat, upper=upper).numpy(), x)


def test_inverse_softplus_polyak_and_hot_encodings_match_reference():
    rng = np.random.default_rng(2)
    x = np.array([1e-3, 0.1, 1.0, 5.0, 19.9, 20.0, 35.0], np.float32)
    assert close(tt.inverse_softplus(_t(x)).numpy(), jt.inverse_softplus(jnp.asarray(x)), TOL)

    a, b = (rng.normal(size=(4, 3)).astype(np.float32) for _ in range(2))
    ref = jt.polyak_update({"w": jnp.asarray(a)}, {"w": jnp.asarray(b)}, 0.05)["w"]
    assert close(tt.polyak_update({"w": _t(a)}, {"w": _t(b)}, 0.05)["w"].numpy(), ref, TOL)
    target, online = torch.nn.Linear(3, 4), torch.nn.Linear(3, 4)
    with torch.no_grad():
        target.weight.copy_(_t(a)), online.weight.copy_(_t(b))
    assert tt.polyak_update(target, online, 0.05) is target
    assert close(target.weight.detach().numpy(), ref, TOL)

    idx = rng.integers(0, 5, size=(3, 4))
    np.testing.assert_array_equal(tt.one_hot(_t(idx), 5).numpy(), np.asarray(jt.one_hot(jnp.asarray(idx), 5)))
    bins = np.linspace(-2.0, 3.0, 11).astype(np.float32)
    v = np.concatenate([rng.uniform(-3, 4, size=20), bins[:3]]).astype(np.float32)  # beyond both ends, and on bins
    got = tt.two_hot(_t(v), _t(bins)).numpy()
    # the reference encodes one scalar per call (its scatter indexes the last
    # axis, so a batch of x would spread over every row)
    for i, x in enumerate(v):
        assert close(got[i], jt.two_hot(jnp.asarray(x), jnp.asarray(bins)), TOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-6)


def test_generate_minibatches_partition_a_permutation():
    batches = list(tt.generate_minibatches(torch.Generator().manual_seed(0), 23, 5))
    assert len(batches) == 4 and all(b.shape == (5,) for b in batches)
    flat = torch.cat(batches)
    assert len(set(flat.tolist())) == 20 and int(flat.max()) < 23
    again = list(tt.generate_minibatches(torch.Generator().manual_seed(0), 23, 5))
    assert all(torch.equal(a, b) for a, b in zip(batches, again))


@pytest.mark.parametrize("name", ["quat_inv_apply", "quat_apply_yaw", "quat_from_axis_angle", "quat_to_matrix", "yaw_quat",
                                  "quat_integrate", "inverse_transform_points"])
def test_math_functions_match_reference(name):
    rng = np.random.default_rng(3)
    q, v = _quat(rng, 8), rng.normal(size=(8, 3)).astype(np.float32)
    q[0] = [0.0, 1.0, 0.0, 0.0]  # no yaw part: yaw_quat's identity branch
    axis = v / np.linalg.norm(v, axis=-1, keepdims=True)
    angle = rng.uniform(-np.pi, np.pi, size=8).astype(np.float32)
    pts, pos = rng.normal(size=(8, 5, 3)).astype(np.float32), rng.normal(size=(8, 3)).astype(np.float32)
    args = {
        "quat_inv_apply": (q, v), "quat_apply_yaw": (q, v), "quat_from_axis_angle": (axis, angle), "quat_to_matrix": (q,),
        "yaw_quat": (q,), "quat_integrate": (q, v, 0.01), "inverse_transform_points": (pts, pos, q),
    }[name]
    conv = [(_t(a), jnp.asarray(a)) if isinstance(a, np.ndarray) else (a, a) for a in args]
    got = getattr(tm, name)(*(c[0] for c in conv)).numpy()
    ref = jax.jit(getattr(jm, name))(*(c[1] for c in conv))  # jitted: op by op the CPU compiles every primitive apart
    assert got.shape == ref.shape and close(got, ref, TOL)
    if name == "inverse_transform_points":  # the inverse of transform_points
        back = tm.transform_points(torch.as_tensor(got), _t(pos), _t(q)).numpy()
        assert close(back, pts, 1e-5)


@pytest.mark.parametrize("dim,n,upper", [(2, 8, False), (3, 16, False), (3, 16, True)])
def test_orientation_grid_matches_reference(dim, n, upper):
    assert close(tm.orientation_grid(dim, n, upper).numpy(), jm.orientation_grid(dim, n, upper), TOL)
    with pytest.raises(ValueError):
        tm.orientation_grid(4, n)
