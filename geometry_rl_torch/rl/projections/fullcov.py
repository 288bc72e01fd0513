"""Full-covariance trust-region projections (port of
`geometry_rl_tpu/rl/projections/fullcov.py`).

The training path uses diagonal policies only; these are here for users who
bring full-covariance Gaussians.

- `kl_full_cov_projection`: the covariance-only KL projection. Its KKT
  conditions give the precision interpolation S(eta)^-1 = (cov^-1 +
  eta * old_cov^-1) / (1 + eta); the scalar dual eta comes from the same
  60-round log-space bisection as the diagonal case (`kl.py`), batched over
  k x k matrices through Cholesky factorisations.
- `kl_full_joint_projection`: the joint mean and covariance projection onto
  the ball of the TOTAL KL, one multiplier: mu*(eta) = (P + eta P_old)^-1
  (P mu + eta P_old mu_old), S*(eta) as above.
- `w2_non_commutative_parts` / `w2_non_commutative_projection`: W2 without
  assuming that the covariances commute, through the eigenvalues of the
  symmetric sqrt @ old_cov @ sqrt and the optimal-transport map.

The bisections run under `no_grad`; the gradient of eta is the implicit
function theorem's (`_ImplicitRoot`, the role of `lax.custom_root` with the
reference's scalar tangent solve): gradients reach the NEW covariance (and,
in the joint case, the new mean) only, and `old_*` and `eps` are constants.
A factorisation that fails gives NaN, as in the reference, and a non-finite
solve falls back to the old covariance.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

_BISECT_ITERS = 60
_ETA_MAX = 1e12


# ---------------------------------------------------------------------------
# batched k x k linear algebra
# ---------------------------------------------------------------------------


def _chol_inverse(mat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(inverse, log-determinant) of a batched SPD matrix via Cholesky; NaN
    where the matrix is not positive definite."""
    chol, info = torch.linalg.cholesky_ex(mat)
    chol = torch.where((info != 0)[..., None, None], torch.nan, chol)
    eye = torch.eye(mat.shape[-1], dtype=mat.dtype, device=mat.device).expand(mat.shape)
    inv = torch.cholesky_solve(eye, chol)
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    return inv, logdet


def _sym(mat: torch.Tensor) -> torch.Tensor:
    return 0.5 * (mat + mat.transpose(-1, -2))


def _trace(mat: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(mat, dim1=-2, dim2=-1).sum(-1)


def _scalar(eps, like: torch.Tensor) -> torch.Tensor:
    """`eps` (a number or a tensor) broadcast to `like`'s batch shape [...]."""
    if torch.is_tensor(eps):
        return torch.broadcast_to(eps.to(like.dtype), like.shape[:-2]).detach()
    return torch.full(like.shape[:-2], eps, dtype=like.dtype, device=like.device)


def kl_cov_part_full(cov: torch.Tensor, old_cov: torch.Tensor) -> torch.Tensor:
    """0.5 [tr(old^-1 cov) - k + logdet(old) - logdet(cov)]."""
    k = cov.shape[-1]
    old_inv, old_logdet = _chol_inverse(old_cov)
    _, logdet = _chol_inverse(cov)
    return 0.5 * (torch.einsum("...ij,...ji->...", old_inv, cov) - k + old_logdet - logdet)


@torch.no_grad()
def _bisect(constraint: Callable[[torch.Tensor], torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    """Log-space bisection on eta in [0, ETA_MAX] per batch element of `like`
    [..., k, k]; the constraint decreases in eta."""
    lo = torch.zeros(like.shape[:-2], dtype=like.dtype, device=like.device)
    hi = torch.full(like.shape[:-2], _ETA_MAX, dtype=like.dtype, device=like.device)
    for _ in range(_BISECT_ITERS):
        mid = torch.expm1(0.5 * (torch.log1p(lo) + torch.log1p(hi)))
        gt = constraint(mid) > 0.0
        lo = torch.where(gt, mid, lo)
        hi = torch.where(gt, hi, mid)
    return 0.5 * (lo + hi)


class _ImplicitRoot(torch.autograd.Function):
    """eta(params), a root of constraint(eta, *params) per batch element, as
    a differentiable function of params: the forward passes the solved eta
    through; the backward gives params the cotangent
    -(d constraint / d params)^T (g / d constraint / d eta), the constraint's
    derivative in eta taken per element (each element's constraint depends on
    its own eta only). Where that derivative is below 1e-20 in magnitude (cov
    == old_cov: the row is discarded by the caller's mask) the cotangent is 0."""

    @staticmethod
    def forward(ctx, eta, constraint, *params):
        ctx.constraint = constraint
        ctx.save_for_backward(eta, *params)
        return eta.clone()

    @staticmethod
    def backward(ctx, g):
        eta, *params = ctx.saved_tensors
        wanted = [i for i, need in enumerate(ctx.needs_input_grad[2:]) if need]
        with torch.enable_grad():
            e = eta.detach().requires_grad_(True)
            ps = [p.detach().requires_grad_(i in wanted) for i, p in enumerate(params)]
            c = ctx.constraint(e, *ps)
            (denom,) = torch.autograd.grad(c, e, torch.ones_like(c), retain_graph=True)
            tiny = denom.abs() < 1e-20
            y = torch.where(tiny, 0.0, g / torch.where(tiny, 1.0, denom))
            grads = torch.autograd.grad(c, [ps[i] for i in wanted], -y, allow_unused=True)
        out = [None] * len(params)
        for i, gr in zip(wanted, grads):
            out[i] = gr
        return (None, None, *out)


# ---------------------------------------------------------------------------
# the covariance-only projection
# ---------------------------------------------------------------------------


def _interp_cov(prec: torch.Tensor, old_prec: torch.Tensor, eta: torch.Tensor) -> torch.Tensor:
    """S(eta) = (1 + eta) * (prec + eta * old_prec)^-1."""
    eta = eta[..., None, None]
    inv, _ = _chol_inverse(_sym((prec + eta * old_prec) / (1.0 + eta)))
    return _sym(inv)


def kl_full_cov_projection(cov: torch.Tensor, old_cov: torch.Tensor, eps) -> torch.Tensor:
    """Project full covariances [..., k, k] into the KL-cov ball of radius
    eps around old_cov. Differentiable w.r.t. `cov` only; non-finite solves
    fall back to old_cov."""
    old_cov = old_cov.detach()
    eps = _scalar(eps, cov)
    old_prec, _ = _chol_inverse(old_cov)

    c0 = kl_cov_part_full(cov.detach(), old_cov)
    active = c0 > eps
    # inactive rows go through the solver as well (so that every row has a
    # root and a finite implicit gradient), against a dummy radius, and are
    # discarded by the final `where`
    eps_solver = torch.where(active, eps, 0.5 * torch.clamp(c0, min=1e-12))

    def constraint(eta, prec):
        return kl_cov_part_full(_interp_cov(prec, old_prec, eta), old_cov) - eps_solver

    prec, _ = _chol_inverse(cov)
    eta = _bisect(lambda e: constraint(e, prec), cov)
    eta = _ImplicitRoot.apply(eta, constraint, prec)
    proj = _interp_cov(prec, old_prec, eta)

    bad = ~torch.isfinite(proj).all(-1, keepdim=True).all(-2, keepdim=True)
    proj = torch.where(bad, old_cov, proj)
    return torch.where(active[..., None, None], proj, cov)


# ---------------------------------------------------------------------------
# the joint mean and covariance projection
# ---------------------------------------------------------------------------


def kl_full_parts(mean, cov, old_mean, old_cov) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean part, cov part) of KL(p || q) for full Gaussians."""
    old_inv, _ = _chol_inverse(old_cov)
    d = mean - old_mean
    return 0.5 * torch.einsum("...i,...ij,...j->...", d, old_inv, d), kl_cov_part_full(cov, old_cov)


def kl_full_joint_projection(mean: torch.Tensor, cov: torch.Tensor, old_mean: torch.Tensor, old_cov: torch.Tensor,
                             eps) -> Tuple[torch.Tensor, torch.Tensor]:
    """Joint projection onto the TOTAL-KL ball of radius eps, one dual
    variable eta: mu*(eta) = (P + eta P_old)^-1 (P mu + eta P_old mu_old),
    S*(eta)^-1 = (P + eta P_old) / (1 + eta). Differentiable w.r.t. mean and
    cov."""
    old_mean, old_cov = old_mean.detach(), old_cov.detach()
    eps = _scalar(eps, cov)
    old_prec, _ = _chol_inverse(old_cov)
    old_term = torch.einsum("...ij,...j->...i", old_prec, old_mean)

    def project(eta, mean, prec):
        mix_inv, _ = _chol_inverse(_sym(prec + eta[..., None, None] * old_prec))
        mu = torch.einsum("...ij,...j->...i", mix_inv,
                          torch.einsum("...ij,...j->...i", prec, mean) + eta[..., None] * old_term)
        return mu, _sym(mix_inv * (1.0 + eta[..., None, None]))

    m0, c0 = kl_full_parts(mean.detach(), cov.detach(), old_mean, old_cov)
    total0 = m0 + c0
    active = total0 > eps
    eps_solver = torch.where(active, eps, 0.5 * torch.clamp(total0, min=1e-12))

    def constraint(eta, mean, prec):
        mp, cp = kl_full_parts(*project(eta, mean, prec), old_mean, old_cov)
        return mp + cp - eps_solver

    prec, _ = _chol_inverse(cov)
    eta = _bisect(lambda e: constraint(e, mean, prec), cov)
    eta = _ImplicitRoot.apply(eta, constraint, mean, prec)
    proj_mean, proj_cov = project(eta, mean, prec)

    bad = (~torch.isfinite(proj_cov).all(-1).all(-1) | ~torch.isfinite(proj_mean).all(-1))[..., None]
    proj_mean = torch.where(bad, old_mean, proj_mean)
    proj_cov = torch.where(bad[..., None], old_cov, proj_cov)
    am = active[..., None]
    return torch.where(am, proj_mean, mean), torch.where(am[..., None], proj_cov, cov)


# ---------------------------------------------------------------------------
# non-commutative Wasserstein-2
# ---------------------------------------------------------------------------


def _inv_sqrt_psd(mat: torch.Tensor) -> torch.Tensor:
    """mat^{-1/2} of a batched symmetric PSD matrix via eigh."""
    vals, vecs = torch.linalg.eigh(mat)
    return torch.einsum("...ik,...k,...jk->...ij", vecs, 1.0 / torch.sqrt(torch.clamp(vals, min=1e-12)), vecs)


def _sqrt_psd(mat: torch.Tensor) -> torch.Tensor:
    vals, vecs = torch.linalg.eigh(mat)
    return torch.einsum("...ik,...k,...jk->...ij", vecs, torch.sqrt(torch.clamp(vals, min=0.0)), vecs)


def w2_non_commutative_parts(mean, sqrt, old_mean, old_sqrt, scale_prec: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean part, cov part) of W2 without assuming commuting covariances.
    sqrt / old_sqrt are symmetric PSD matrix square roots [..., k, k]."""
    cov = sqrt @ sqrt
    old_cov = old_sqrt @ old_sqrt
    if scale_prec:
        old_inv, _ = _chol_inverse(old_cov)
        d = mean - old_mean
        mean_part = torch.einsum("...i,...ij,...j->...", d, old_inv, d)
        old_sqrt_inv = _inv_sqrt_psd(old_cov)
        c = _sym(old_sqrt_inv @ cov @ old_sqrt_inv)
        vals = torch.linalg.eigvalsh(c)
        cov_part = cov.shape[-1] + _trace(c) - 2.0 * torch.sqrt(torch.clamp(vals, min=0.0)).sum(-1)
    else:
        mean_part = ((mean - old_mean) ** 2).sum(-1)
        # the spectrum of cov @ old_cov is that of the symmetric sqrt @ old_cov @ sqrt
        vals = torch.linalg.eigvalsh(_sym(sqrt @ old_cov @ sqrt))
        cov_part = _trace(cov) + _trace(old_cov) - 2.0 * torch.sqrt(torch.clamp(vals, min=0.0)).sum(-1)
    return mean_part, cov_part


def w2_non_commutative_projection(mean, sqrt, old_mean, old_sqrt, eps, scale_prec: bool = False
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Geodesic W2 projection for non-commuting covariances: a joint bound
    eps on mean part + cov part, t = sqrt(eps / total), the mean moved along
    the line and the covariance along the Bures-Wasserstein geodesic
    S_t = D old_cov D, D = (1 - t) I + t W, W = sqrt (sqrt old_cov sqrt)^-1/2
    sqrt the optimal-transport map. Returns (proj_mean, proj_sqrt)."""
    mean_part, cov_part = w2_non_commutative_parts(mean, sqrt, old_mean, old_sqrt, scale_prec)
    total = mean_part + cov_part
    mask = total > eps
    t = torch.where(mask, torch.sqrt(eps / torch.clamp(total, min=1e-16)), 1.0)

    proj_mean = torch.where(mask[..., None], (1.0 - t)[..., None] * old_mean + t[..., None] * mean, mean)

    old_cov = old_sqrt @ old_sqrt
    w = sqrt @ _inv_sqrt_psd(_sym(sqrt @ old_cov @ sqrt)) @ sqrt
    eye = torch.eye(sqrt.shape[-1], dtype=sqrt.dtype, device=sqrt.device).expand(sqrt.shape)
    d = (1.0 - t)[..., None, None] * eye + t[..., None, None] * w
    proj_sqrt = torch.where(mask[..., None, None], _sqrt_psd(_sym(d @ old_cov @ d)), sqrt)
    return proj_mean, proj_sqrt


# ---------------------------------------------------------------------------
# layers over (mean, cov) / (mean, sqrt) tuples
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FullCovKLProjection:
    """The KL layer for full covariances: the closed-form mean projection
    onto the Mahalanobis ball and the covariance-only dual solve."""

    mean_bound: float = 0.05
    cov_bound: float = 1e-3

    def __call__(self, mean, cov, old_mean, old_cov):
        old_inv, _ = _chol_inverse(old_cov)
        d = mean - old_mean
        maha = 0.5 * torch.einsum("...i,...ij,...j->...", d, old_inv, d)
        omega = torch.abs(torch.sqrt(torch.clamp(maha, min=1e-16) / self.mean_bound) - 1.0)[..., None]
        interp = (mean + omega * old_mean) / (1.0 + omega + 1e-16)
        proj_mean = torch.where((maha > self.mean_bound)[..., None], interp, mean)
        return proj_mean, kl_full_cov_projection(cov, old_cov, self.cov_bound)


@dataclasses.dataclass(frozen=True)
class FullCovW2NonCommutingProjection:
    """The non-commutative W2 layer (joint bound mean_bound + cov_bound)."""

    mean_bound: float = 0.05
    cov_bound: float = 1e-3
    scale_prec: bool = False

    def __call__(self, mean, sqrt, old_mean, old_sqrt):
        return w2_non_commutative_projection(mean, sqrt, old_mean, old_sqrt, self.mean_bound + self.cov_bound,
                                             self.scale_prec)
