"""Procedural peg/hole geometry and analytic SDFs (port of
`geometry_rl_tpu/sim/shapes.py`).

The outlines, prism meshes and contact samples are numpy, built once; the
shape set holds them as padded tensors (env e uses shape e % S). The SDFs
take torch tensors. Where the reference vmaps over per-env outlines, these
take outlines with the env axis in front ([B, K, 2]) and broadcast them over
the points of that env.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

SHAPE_NAMES = ("plus", "pentagon", "star", "T", "diamond", "heart", "hexagon", "triangle")


# ---------------------------------------------------------------------------
# 2D outlines (unit scale ~[-1, 1], CCW)
# ---------------------------------------------------------------------------


def _regular_polygon(n: int, radius: float = 1.0, phase: float = 0.0) -> np.ndarray:
    ang = phase + 2 * np.pi * np.arange(n) / n
    return np.stack([radius * np.cos(ang), radius * np.sin(ang)], axis=-1)


def _star(n_spikes: int = 5, r_out: float = 1.0, r_in: float = 0.45) -> np.ndarray:
    ang = np.pi / 2 + 2 * np.pi * np.arange(2 * n_spikes) / (2 * n_spikes)
    r = np.where(np.arange(2 * n_spikes) % 2 == 0, r_out, r_in)
    return np.stack([r * np.cos(ang), r * np.sin(ang)], axis=-1)


def _plus(arm: float = 1.0, thick: float = 0.4) -> np.ndarray:
    a, t = arm, thick
    return np.array(
        [
            (t, t), (t, a), (-t, a), (-t, t), (-a, t), (-a, -t),
            (-t, -t), (-t, -a), (t, -a), (t, -t), (a, -t), (a, t),
        ]
    )


def _tee(width: float = 1.0, bar: float = 0.4, stem: float = 0.4) -> np.ndarray:
    w, b, s = width, bar, stem
    return np.array(
        [
            (w, 1.0), (-w, 1.0), (-w, 1.0 - 2 * b), (-s / 2, 1.0 - 2 * b),
            (-s / 2, -1.0), (s / 2, -1.0), (s / 2, 1.0 - 2 * b), (w, 1.0 - 2 * b),
        ]
    )[::-1].copy()  # listed CW; reverse to CCW


def _ensure_ccw(o: np.ndarray) -> np.ndarray:
    x, y = o[:, 0], o[:, 1]
    area = 0.5 * np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y)
    return o if area > 0 else o[::-1].copy()


def _diamond() -> np.ndarray:
    return np.array([(1.0, 0.0), (0.0, 1.4), (-1.0, 0.0), (0.0, -1.4)])


def _heart(n: int = 16) -> np.ndarray:
    # classic heart curve, normalized to ~unit radius
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    x = 16 * np.sin(t) ** 3
    y = 13 * np.cos(t) - 5 * np.cos(2 * t) - 2 * np.cos(3 * t) - np.cos(4 * t)
    pts = np.stack([x, y], axis=-1) / 16.0
    return pts[::-1]  # CCW


def _triangle() -> np.ndarray:
    return _regular_polygon(3, radius=1.0, phase=np.pi / 2)


def _letter_a(w: float = 0.8, t: float = 0.35) -> np.ndarray:
    # simplified solid "A" silhouette (triangle with flat feet), no counter
    return np.array(
        [
            (w, -1.0), (w - t, -1.0), (0.35, 0.2), (-0.35, 0.2),
            (-(w - t), -1.0), (-w, -1.0), (-0.25, 1.0), (0.25, 1.0),
        ]
    )


def _letter_e(w: float = 0.7, t: float = 0.3) -> np.ndarray:
    # solid "E" outline
    return np.array(
        [
            (w, 1.0), (-w, 1.0), (-w, -1.0), (w, -1.0), (w, -1.0 + t),
            (-w + t, -1.0 + t), (-w + t, -t / 2), (w * 0.7, -t / 2),
            (w * 0.7, t / 2), (-w + t, t / 2), (-w + t, 1.0 - t), (w, 1.0 - t),
        ]
    )[::-1].copy()


def _letter_l(w: float = 0.9, t: float = 0.4) -> np.ndarray:
    # "L" silhouette: the sliding task's object
    return np.array(
        [(-w, 1.0), (-w, -1.0), (w, -1.0), (w, -1.0 + t), (-w + t, -1.0 + t), (-w + t, 1.0)]
    )[::-1].copy()


SHAPE_OUTLINES: Dict[str, np.ndarray] = {
    name: _ensure_ccw(outline)
    for name, outline in {
        "plus": _plus(),
        "pentagon": _regular_polygon(5, phase=np.pi / 2),
        "star": _star(),
        "T": _tee(),
        "diamond": _diamond(),
        "heart": _heart(),
        "hexagon": _regular_polygon(6),
        "triangle": _triangle(),
        # pushing uses 10 shapes (adds A, E); sliding uses the L object
        "A": _letter_a(),
        "E": _letter_e(),
        "L": _letter_l(),
    }.items()
}

PUSHING_SHAPE_NAMES = ("plus", "pentagon", "star", "T", "A", "E", "diamond", "heart", "hexagon", "triangle")


# ---------------------------------------------------------------------------
# prism meshes (observation geometry)
# ---------------------------------------------------------------------------


class ShapeSet(NamedTuple):
    """Padded multi-shape geometry batch; masks carry validity."""

    names: Tuple[str, ...]
    points: torch.Tensor  # [S, P_max, 3] local-frame mesh points
    point_mask: torch.Tensor  # [S, P_max]
    num_points: torch.Tensor  # [S]
    edges: torch.Tensor  # [S, E_max, 2] indices into points
    edge_mask: torch.Tensor  # [S, E_max]
    num_edges: torch.Tensor  # [S]
    outline: torch.Tensor  # [S, K_max, 2] polygon outline (scaled)
    outline_mask: torch.Tensor  # [S, K_max]
    surface_points: torch.Tensor  # [S, C_max, 3] contact sample points
    half_height: float
    scale: float


def prism_mesh(outline: np.ndarray, half_height: float) -> Tuple[np.ndarray, np.ndarray]:
    """Extrude a 2D outline to a prism: points [2K, 3], edges (outline top +
    bottom rings + verticals) [3K, 2]."""
    k = outline.shape[0]
    bottom = np.concatenate([outline, np.full((k, 1), -half_height)], axis=-1)
    top = np.concatenate([outline, np.full((k, 1), half_height)], axis=-1)
    points = np.concatenate([bottom, top], axis=0)
    ring_b = np.stack([np.arange(k), (np.arange(k) + 1) % k], axis=-1)
    ring_t = ring_b + k
    vertical = np.stack([np.arange(k), np.arange(k) + k], axis=-1)
    edges = np.concatenate([ring_b, ring_t, vertical], axis=0)
    return points, edges


def surface_samples(outline: np.ndarray, half_height: float, n_z: int = 3) -> np.ndarray:
    """Contact sample points: outline vertices + edge midpoints at n_z
    z-levels (bottom, middle, top)."""
    mids = 0.5 * (outline + np.roll(outline, -1, axis=0))
    ring = np.concatenate([outline, mids], axis=0)
    zs = np.linspace(-half_height, half_height, n_z)
    pts = np.concatenate([np.concatenate([ring, np.full((len(ring), 1), z)], axis=-1) for z in zs], axis=0)
    return pts


def build_shape_set(
    names=SHAPE_NAMES, scale: float = 0.1, half_height: float = 0.05, clearance: float = 0.0, device=None
) -> ShapeSet:
    """The padded shape batch at physical scale (outline units ~[-1, 1]
    mapped to `scale` metres), as tensors on `device`."""
    outlines = [SHAPE_OUTLINES[n] * scale for n in names]
    meshes = [prism_mesh(o, half_height) for o in outlines]
    samples = [surface_samples(o, half_height) for o in outlines]

    p_max = max(m[0].shape[0] for m in meshes)
    e_max = max(m[1].shape[0] for m in meshes)
    k_max = max(o.shape[0] for o in outlines)
    c_max = max(s.shape[0] for s in samples)

    S = len(names)
    points = np.zeros((S, p_max, 3), np.float32)
    pmask = np.zeros((S, p_max), np.float32)
    edges = np.zeros((S, e_max, 2), np.int32)
    emask = np.zeros((S, e_max), np.float32)
    outline_arr = np.zeros((S, k_max, 2), np.float32)
    omask = np.zeros((S, k_max), np.float32)
    surf = np.zeros((S, c_max, 3), np.float32)
    n_pts = np.zeros((S,), np.int32)
    n_edg = np.zeros((S,), np.int32)

    for i, ((pts, edg), o, sp) in enumerate(zip(meshes, outlines, samples)):
        points[i, : len(pts)] = pts
        pmask[i, : len(pts)] = 1.0
        edges[i, : len(edg)] = edg
        emask[i, : len(edg)] = 1.0
        outline_arr[i, : len(o)] = o * (1.0 + clearance)
        # pad by repeating the FIRST vertex (see polygon_sdf_2d contract)
        outline_arr[i, len(o) :] = o[0] * (1.0 + clearance)
        omask[i, : len(o)] = 1.0
        surf[i, : len(sp)] = sp
        surf[i, len(sp) :] = sp[-1]  # repeat (extra identical contact points)
        n_pts[i] = len(pts)
        n_edg[i] = len(edg)

    def t(a):
        return torch.as_tensor(a, device=device)

    return ShapeSet(
        names=tuple(names), points=t(points), point_mask=t(pmask), num_points=t(n_pts), edges=t(edges),
        edge_mask=t(emask), num_edges=t(n_edg), outline=t(outline_arr), outline_mask=t(omask),
        surface_points=t(surf), half_height=half_height, scale=scale,
    )


# ---------------------------------------------------------------------------
# analytic polygon SDF
# ---------------------------------------------------------------------------


def _segments(q: torch.Tensor, verts: torch.Tensor):
    """Polygon segments a -> b of `verts` [*batch, K, 2], shaped to broadcast
    against the queries q [*batch, *points, 2] with a K axis before the last:
    (a, b, e = b - a), each [*batch, 1..., K, 2]."""
    batch = verts.shape[:-2]
    a = verts.reshape(batch + (1,) * (q.ndim - verts.ndim + 1) + verts.shape[-2:])
    b = torch.roll(a, -1, dims=-2)
    return a, b, b - a


def _inside(q: torch.Tensor, a: torch.Tensor, b: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Even-odd crossing test (degenerate pad segments never straddle)."""
    qy = q[..., None, 1]
    cond = (a[..., 1] <= qy) != (b[..., 1] <= qy)
    denom = torch.where(torch.abs(e[..., 1]) < 1e-12, 1e-12, e[..., 1])
    x_int = a[..., 0] + (qy - a[..., 1]) / denom * e[..., 0]
    crossing = cond & (q[..., None, 0] < x_int)
    return crossing.sum(dim=-1) % 2 == 1


def polygon_sdf_2d(q: torch.Tensor, verts: torch.Tensor) -> torch.Tensor:
    """Signed distance of 2D points q [*batch, *points, 2] to padded polygons
    verts [*batch, K, 2], negative inside. Polygons are padded by REPEATING
    THE FIRST VERTEX: the closing segment (last real vertex -> v0 copy) then
    carries real geometry and every further pad segment has zero length,
    adding neither distance error nor ray crossings."""
    a, b, e = _segments(q, verts)
    w = q[..., None, :] - a  # [..., K, 2]
    ee = torch.clamp((e * e).sum(dim=-1), min=1e-12)
    t = torch.clamp((w * e).sum(dim=-1) / ee, 0.0, 1.0)
    diff = w - t[..., None] * e
    d2 = (diff * diff).sum(dim=-1)  # [..., K]
    dist = torch.sqrt(d2.amin(dim=-1))
    return torch.where(_inside(q, a, b, e), -dist, dist)


def polygon_sdf_grad_2d(q: torch.Tensor, verts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Signed distance AND analytic gradient of 2D points to padded polygons
    (same contract as `polygon_sdf_2d`): grad = (q - q*) / phi with q* the
    closest boundary point, the mean of the (usually unique) minimisers."""
    a, b, e = _segments(q, verts)
    qe = q[..., None, :]
    w = qe - a
    ee = torch.clamp((e * e).sum(dim=-1), min=1e-12)
    t = torch.clamp((w * e).sum(dim=-1) / ee, 0.0, 1.0)
    closest = a + t[..., None] * e  # [..., K, 2]
    diff = qe - closest
    d2 = (diff * diff).sum(dim=-1)
    d2_min = d2.amin(dim=-1, keepdim=True)
    dist = torch.sqrt(d2_min[..., 0])
    sel = (d2 <= d2_min + 1e-12).to(q.dtype)
    qstar = (sel[..., None] * closest).sum(dim=-2) / torch.clamp(sel.sum(dim=-1, keepdim=True), min=1.0)

    phi = torch.where(_inside(q, a, b, e), -dist, dist)
    grad = (q - qstar) / torch.where(torch.abs(phi) < 1e-9, 1e-9, phi)[..., None]
    return phi, grad


def hole_plate_sdf(
    points_local: torch.Tensor,
    outline: torch.Tensor,
    plate_half_extent: float,
    plate_top: float,
    plate_bottom: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SDF of a square plate with a shape-hole, in the plate's local frame:
    { |x|,|y| <= plate_half_extent, bottom <= z <= top } minus the hole prism
    { polygon(x, y) < 0 }. Normals are analytic subgradients of the max
    composition. points_local [*batch, *points, 3], outline [*batch, K, 2];
    returns (phi [...], normal [..., 3]) with phi < 0 inside the solid."""
    x, y, z = points_local.unbind(-1)
    q2 = points_local[..., :2]
    zeros = torch.zeros_like(x)

    # slab SDF (plate without hole): max of face distances, with face normals
    dx = torch.abs(x) - plate_half_extent
    dy = torch.abs(y) - plate_half_extent
    z_low = plate_bottom - z
    z_high = z - plate_top
    dz = torch.maximum(z_low, z_high)
    n_z = torch.stack([zeros, zeros, torch.where(z_high >= z_low, 1.0, -1.0)], dim=-1)
    slab = torch.maximum(torch.maximum(dx, dy), dz)
    n_slab = torch.where(
        ((dx >= dy) & (dx >= dz))[..., None],
        torch.stack([torch.sign(x), zeros, zeros], dim=-1),
        torch.where((dy >= dz)[..., None], torch.stack([zeros, torch.sign(y), zeros], dim=-1), n_z),
    )

    poly, poly_grad = polygon_sdf_grad_2d(q2, outline)
    # solid = slab \ hole -> phi = max(slab, -hole_prism), with the prism
    # existing only within the slab's z range: hole_prism = max(poly, dz)
    hole_prism = torch.maximum(poly, dz)
    n_hole = torch.where((poly >= dz)[..., None], torch.cat([poly_grad, zeros[..., None]], dim=-1), n_z)
    phi = torch.maximum(slab, -hole_prism)
    n = torch.where((slab >= -hole_prism)[..., None], n_slab, -n_hole)
    n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-9)
    return phi, n


def ground_sdf(points: torch.Tensor, height: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ground plane z = height."""
    phi = points[..., 2] - height
    n = torch.zeros_like(points)
    n[..., 2].fill_(1.0)  # a fill kernel, no copy from the host
    return phi, n
