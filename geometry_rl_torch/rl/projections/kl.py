"""Differentiable diagonal KL covariance projection (port of
`geometry_rl_tpu/rl/projections/kl.py`).

Per batch element, with variances v, v_old > 0:

    min_{v*}  KLcov(v* || v)   s.t.  KLcov(v* || v_old) <= eps,
    KLcov(a || b) = 0.5 * sum_i [ a_i/b_i - 1 + log b_i - log a_i ].

The solution interpolates in precision space, 1/v* = (1/v + eta/v_old) /
(1 + eta), with the scalar dual eta >= 0 found by a fixed 60-step bisection
in log1p space; the backward differentiates it by the implicit function
theorem. Gradients reach the new variance only (None for old_var and eps);
where the solve is not finite the projection falls back to v_old with no
gradient.

`_solve_eta` bisects CUDA tensors in one launch of `csrc/kl_bisection.cu`
(no fallback: the kernel or an exception) and CPU tensors in the plain
version `_solve_eta_plain`, 60 rounds of small elementwise ops; on the card
the two give the same bits. Each launch counts `kernels.kl_bisection`.
"""

from __future__ import annotations

import ctypes

import torch

from ...utils.trace import count, spanned

_BISECT_ITERS = 60  # 2^-60 relative bracket width, beyond f32 resolution
_ETA_MAX = 1e12
# the widest last axis the kernel holds in registers without a spill (csrc/kl_bisection.cu, kMaxK)
KERNEL_MAX_K = 16
# the C entry `kl_bisection_launch`: var, old_var, eps, eps's stride, eta, rows, K, rounds, eta_max, the stream
KERNEL_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_float, ctypes.c_void_p]


def _kl_cov_diag(var_p: torch.Tensor, var_q: torch.Tensor) -> torch.Tensor:
    """0.5 * sum(v_p/v_q - 1 - log(v_p/v_q)) over the last axis."""
    ratio = var_p / var_q
    return 0.5 * (ratio - 1.0 - torch.log(ratio)).sum(-1)


def _interp_var(var: torch.Tensor, old_var: torch.Tensor, eta: torch.Tensor) -> torch.Tensor:
    """v*(eta): precision-space interpolation between var (eta=0) and old_var."""
    eta = eta[..., None]
    return (1.0 + eta) / (1.0 / var + eta / old_var)


def _solve_eta_plain(var: torch.Tensor, old_var: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """Bisection for eta per batch element on [0, ETA_MAX]; eta = 0 where
    the constraint already holds at eta = 0."""

    def constraint(eta):
        return _kl_cov_diag(_interp_var(var, old_var, eta), old_var) - eps

    lo = torch.zeros(var.shape[:-1], dtype=var.dtype, device=var.device)
    hi = torch.full(var.shape[:-1], _ETA_MAX, dtype=var.dtype, device=var.device)
    needs_proj = constraint(lo) > 0.0
    for _ in range(_BISECT_ITERS):
        mid = torch.expm1(0.5 * (torch.log1p(lo) + torch.log1p(hi)))
        gt = constraint(mid) > 0.0  # still violating -> need larger eta
        lo = torch.where(gt, mid, lo)
        hi = torch.where(gt, hi, mid)
    eta = 0.5 * (lo + hi)
    return torch.where(needs_proj, eta, torch.zeros_like(eta))


def _kernel_fn():
    """The ctypes entry `kl_bisection_launch` of `csrc/kl_bisection.cu`, built at first use."""
    from ...cuda_build import load_library

    fn = load_library("kl_bisection").kl_bisection_launch
    if fn.argtypes is None:
        fn.argtypes, fn.restype = KERNEL_ARGTYPES, ctypes.c_int
    return fn


def _solve_eta_cuda(var: torch.Tensor, old_var: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """`_solve_eta_plain`'s eta from one launch of `csrc/kl_bisection.cu` on
    the current stream: var, old_var [..., K] and eps [...] (a stride-0 view
    of one bound too), f32 on the card, 1 <= K <= KERNEL_MAX_K. Raises on
    operands the kernel does not take; never reads the card from the host."""
    if var.dtype != torch.float32 or old_var.dtype != torch.float32 or eps.dtype != torch.float32:
        raise TypeError(f"the KL bisection kernel takes f32, got {var.dtype}, {old_var.dtype}, {eps.dtype}")
    if var.ndim < 1 or not 1 <= var.shape[-1] <= KERNEL_MAX_K:
        raise ValueError(f"the KL bisection kernel holds a last axis of 1 to {KERNEL_MAX_K} in registers, got "
                         f"shape {tuple(var.shape)}")
    if old_var.shape != var.shape or eps.shape != var.shape[:-1]:
        raise ValueError(f"shapes {tuple(var.shape)}, {tuple(old_var.shape)}, {tuple(eps.shape)}: expected "
                         f"var and old_var [..., K], eps [...]")
    dev = var.device
    if dev.type != "cuda" or old_var.device != dev or eps.device != dev:
        raise ValueError(f"the KL bisection kernel needs CUDA tensors on one card, got {dev}, {old_var.device}, "
                         f"{eps.device}")
    var, old_var = var.contiguous(), old_var.contiguous()
    eps_stride = 0 if all(s == 0 for s in eps.stride()) else 1  # one bound broadcast to every row: read in place
    if eps_stride:
        eps = eps.contiguous()
    eta = torch.empty(var.shape[:-1], dtype=var.dtype, device=dev)
    with torch.cuda.device(dev):
        err = _kernel_fn()(var.data_ptr(), old_var.data_ptr(), eps.data_ptr(), eps_stride, eta.data_ptr(),
                           eta.numel(), var.shape[-1], _BISECT_ITERS, _ETA_MAX,
                           torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"KL bisection kernel launch failed: CUDA error {err}")
    count("kernels.kl_bisection")
    return eta


@spanned("rl.kl_bisection")
def _solve_eta(var: torch.Tensor, old_var: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """Bisection for eta per batch element on [0, ETA_MAX]; eta = 0 where
    the constraint already holds at eta = 0. The kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if var.device.type == "cuda":
        return _solve_eta_cuda(var, old_var, eps)
    return _solve_eta_plain(var, old_var, eps)


class KLDiagCovProjection(torch.autograd.Function):
    """`_kl_diag_cov_projection` with its custom VJP (`kl.py:93-147`)."""

    @staticmethod
    def forward(ctx, var, old_var, eps):
        with torch.no_grad():
            eta = _solve_eta(var, old_var, eps)
            proj = _interp_var(var, old_var, eta)
            # fallback: keep the old variance where the solve went non-finite
            bad = ~torch.isfinite(proj).all(-1, keepdim=True)
            proj = torch.where(bad, old_var, proj)
        ctx.save_for_backward(var, old_var, eta, bad)
        return proj

    @staticmethod
    def backward(ctx, g):
        var, old_var, eta, bad = ctx.saved_tensors
        active = eta > 0.0
        e = eta[..., None]
        # f(v, eta) = (1+eta) / (1/v + eta/v_old); c(v, eta) = KLcov(f || v_old) - eps
        # dproj/dv = f_v + f_eta * deta/dv, deta/dv = -c_v / c_eta
        denom = 1.0 / var + e / old_var  # = (1+eta)/proj
        proj = (1.0 + e) / denom
        f_v = (1.0 + e) / (denom * var) ** 2
        f_eta = (1.0 / var - 1.0 / old_var) / denom**2
        c_proj = 0.5 * (1.0 / old_var - 1.0 / proj)
        c_v = c_proj * f_v
        c_eta = (c_proj * f_eta).sum(-1)
        g_f_eta = (g * f_eta).sum(-1)
        safe_c_eta = torch.where(active, c_eta, torch.ones_like(c_eta))
        correction = c_v * (g_f_eta / safe_c_eta)[..., None]
        d_var = torch.where(active[..., None], g * f_v - correction, g)  # inactive: identity
        d_var = torch.where(bad, torch.zeros_like(d_var), d_var)  # fallback: no gradient
        return d_var, None, None


def kl_diag_cov_projection(var: torch.Tensor, old_var: torch.Tensor, eps) -> torch.Tensor:
    """Project `var` into the KL ball of radius `eps` around `old_var`.
    var, old_var [..., K]; eps a scalar or [...]. Differentiable w.r.t. `var`
    only."""
    if torch.is_tensor(eps):
        eps = torch.broadcast_to(eps.to(dtype=var.dtype, device=var.device), var.shape[:-1])
    else:  # filled on the device: a host scalar would be a copy and a sync
        eps = torch.full(var.shape[:-1], eps, dtype=var.dtype, device=var.device)
    return KLDiagCovProjection.apply(var, old_var, eps)
