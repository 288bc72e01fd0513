"""Host helpers of `geometry_rl_tpu/native/` as numpy (port of its
`edges_from_faces`, `diag_kl_project` and `polygon_sdf`).

The JAX package builds these from C++ (`geomrl_native.cpp`) and binds them
with ctypes; here they are numpy with the same semantics: the same edge
order, the same bisection on log1p(eta) with the KL in float64 and the
candidate variances rounded to float32, the same float32 arithmetic and
sign convention (negative inside) of the polygon SDF. Its kNN graph is
`graphs/rigid.knn_edges` / `knn_graph_batch`.
"""

from __future__ import annotations

import numpy as np

BISECTION_STEPS = 200


def edges_from_faces(faces: np.ndarray) -> np.ndarray:
    """Unique undirected edges `[E, 2]` (smaller index first, sorted) of
    triangle faces `[F, 3]`."""
    f = np.asarray(faces, np.int32).reshape(-1, 3)
    pairs = np.stack([f, np.roll(f, -1, axis=1)], axis=-1).reshape(-1, 2)  # (v0,v1), (v1,v2), (v2,v0) per face
    pairs = np.sort(pairs, axis=1)
    return np.unique(pairs, axis=0).astype(np.int32).reshape(-1, 2)


def _kl_cov(vp: np.ndarray, vq: np.ndarray) -> np.ndarray:
    """0.5 * sum(r - 1 - log r), r = vp / vq, in float64 per row."""
    r = vp.astype(np.float64) / vq.astype(np.float64)
    return 0.5 * (r - 1.0 - np.log(r)).sum(axis=-1)


def diag_kl_project(var: np.ndarray, old_var: np.ndarray, eps) -> np.ndarray:
    """Per row of `var` / `old_var` `[batch, dim]`: `var` where its KL to
    `old_var` is within `eps` (a scalar or `[batch]`), else the variance
    1/v* = (1/v + eta/v_old) / (1 + eta) with eta >= 0 found by bisection
    on log1p(eta) so that the KL is `eps`."""
    v = np.asarray(var, np.float32)
    vo = np.asarray(old_var, np.float32)
    e = np.broadcast_to(np.asarray(eps, np.float32), v.shape[:1])
    v64, vo64 = v.astype(np.float64), vo.astype(np.float64)

    def candidate(eta):
        return ((1.0 + eta[:, None]) / (1.0 / v64 + eta[:, None] / vo64)).astype(np.float32)

    lo, hi = np.zeros(v.shape[0]), np.full(v.shape[0], 1e12)
    for _ in range(BISECTION_STEPS):
        mid = np.expm1(0.5 * (np.log1p(lo) + np.log1p(hi)))
        above = _kl_cov(candidate(mid), vo) > e
        lo, hi = np.where(above, mid, lo), np.where(above, hi, mid)
    inside = (_kl_cov(v, vo) <= e)[:, None]
    return np.where(inside, v, candidate(0.5 * (lo + hi)))


def polygon_sdf(verts: np.ndarray, query: np.ndarray) -> np.ndarray:
    """Signed distance `[N]` (negative inside, even-odd rule) of 2D points
    `query` `[N, 2]` to the closed polygon `verts` `[K, 2]` (padded by
    repeating the first vertex), in float32."""
    v = np.asarray(verts, np.float32)
    q = np.asarray(query, np.float32)
    a, b = v, np.roll(v, -1, axis=0)  # edge k: vertex k -> k+1 (mod K)
    e = b - a  # [K, 2]
    w = q[:, None, :] - a[None]  # [N, K, 2]
    ee = np.maximum(e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1], np.float32(1e-12))
    t = np.minimum(np.float32(1.0), np.maximum(np.float32(0.0), (w[..., 0] * e[:, 0] + w[..., 1] * e[:, 1]) / ee))
    dx, dy = w[..., 0] - t * e[:, 0], w[..., 1] - t * e[:, 1]
    best = np.min(np.concatenate([np.full((q.shape[0], 1), 1e30, np.float32), dx * dx + dy * dy], axis=1), axis=1)
    py = q[:, 1:2]
    ey = np.where(e[:, 1] == 0.0, np.float32(1e-12), e[:, 1])
    xint = a[:, 0] + (py - a[:, 1]) / ey * e[:, 0]
    crossing = ((a[:, 1] <= py) != (b[:, 1] <= py)) & (q[:, 0:1] < xint)
    inside = (crossing.sum(axis=1) % 2) == 1
    return np.where(inside, -np.sqrt(best), np.sqrt(best)).astype(np.float32)
