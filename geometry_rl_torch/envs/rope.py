"""Rope manipulation tasks: closing (wrap a pole) and shaping (match a curve).

Port of `geometry_rl_tpu/envs/rope.py`: the rope is an XPBD particle chain
with distance constraints in two conflict-free groups (40 links / 5 m for
closing, 80 links / 10 m for shaping); the two gripper cubes are rigid bodies
pinned to the end links by two-way attachments. All physics is
`sim/xpbd.step_physics` on particles; no fused kernel is on this path.

Observation groups:
  scalars           = zeros [B, 1] (placeholder term)
  position_vectors  = grippers (2x3) | links (Lx3) | target_geometry (Lx3)
                      (the hanger position repeated per link for closing; the
                      yaw-rotated target curve for shaping)
  velocity_vectors  = grippers (2x3) | links (Lx3)

Rewards:
  closing: -2 * gripper xy distance (last 20 steps) - 0.8 * |rope centroid -
           hanger|_xy - 1e-2 * mean link speed - 1e-3 * action rate
  shaping: -1 * shape-descriptor MSE (x5 in the last 10 steps) - 1e-4 * action rate

`step` draws a fresh layout for every env on every step and selects those of
the envs that finished with `torch.where`; every constant lives on the device
from `__init__` on, so a rollout on the card never waits for the host.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..parallel.mesh import Rows, draw_rows
from ..sim.shapes import ground_sdf
from ..sim.types import ParticleState, RigidBodySpec, RigidBodyState, SceneState, box_inertia
from ..sim.xpbd import (
    BodyAttachment,
    DistanceGroup,
    ParticleSDFContact,
    ParticleSpec,
    attachment_sum_order,
    step_physics,
)
from ..utils.math import quat_identity, sample_uniform
from ..utils.trace import span, spanned
from .base import ObsSpec, TimeStep


def w_shape_curve(num_points: int, length: float, z: float = 0.1) -> np.ndarray:
    """Procedural stand-in for the LASA WShape demo: a smoothed W polyline
    resampled to `num_points` with total arc length `length`."""
    ctrl = np.array([(0.0, 0.0), (1.0, -1.6), (2.0, -0.3), (3.0, -1.6), (4.0, 0.0)], dtype=np.float64)
    dense = []
    n_seg = 200
    for i in range(len(ctrl) - 1):
        a, b = ctrl[i], ctrl[i + 1]
        for t in np.linspace(0, 1, n_seg, endpoint=False):
            dense.append(a + t * (b - a))
    dense.append(ctrl[-1])
    dense = np.asarray(dense)
    # mild smoothing (box filter over the edge-padded polyline)
    k = 41
    kernel = np.ones(k) / k
    sm = dense.copy()
    for d in range(2):
        sm[:, d] = np.convolve(np.pad(dense[:, d], (k // 2, k // 2), mode="edge"), kernel, mode="valid")
    # arc-length resample
    seg = np.linalg.norm(np.diff(sm, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    total = s[-1]
    targets = np.linspace(0, total, num_points)
    pts = np.stack([np.interp(targets, s, sm[:, 0]), np.interp(targets, s, sm[:, 1])], axis=1)
    pts *= length / total
    pts -= pts.mean(0)  # center
    out = np.concatenate([pts, np.full((num_points, 1), z)], axis=1)
    return out.astype(np.float32)


def load_target_curve(path: str, num_links: int, rope_length: float, z: float = 0.1) -> np.ndarray:
    """A shaping target polyline from a file: index-space linear
    interpolation of the raw 2D trace to `num_links` points, scaled so the
    polyline's total length equals `rope_length`, with a constant z appended.

    Formats: `.mat` (a pyLasaDataset shape file such as WShape.mat; demo 0's
    `pos` [2, T] trace), `.npy`, `.npz` (first array), `.json`, and `.csv` or
    anything else as comma-separated text: a [2, T] or [T, 2] polyline (or
    [T, 3] / [3, T]; the z part is ignored)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".mat":
        import scipy.io

        mat = scipy.io.loadmat(path)
        demo0 = mat["demos"][0, 0]
        # demos is a [1, D] cell of structs with a field 'pos' [2, T]
        pos = np.asarray(demo0["pos"][0, 0] if demo0.dtype.names else demo0, dtype=np.float64)
    else:
        if ext == ".npy":
            pos = np.load(path)
        elif ext == ".npz":
            data = np.load(path)
            pos = data[list(data.keys())[0]]
        elif ext == ".json":
            import json

            with open(path) as f:
                pos = np.asarray(json.load(f), dtype=np.float64)
        else:  # csv / txt
            pos = np.loadtxt(path, delimiter=",")
        pos = np.asarray(pos, dtype=np.float64)
        if pos.ndim != 2:
            raise ValueError(f"target curve must be 2D, got shape {pos.shape}")
        if pos.shape[0] not in (2, 3):  # [T, 2] / [T, 3] -> [2, T]
            pos = pos.T
        pos = pos[:2]
    t = np.arange(pos.shape[1])
    interp_points = np.linspace(0.0, pos.shape[1] - 1, num_links)
    pts = np.stack([np.interp(interp_points, t, pos[0]), np.interp(interp_points, t, pos[1])], axis=1)
    total = np.linalg.norm(np.diff(pts, axis=0), axis=1).sum()
    pts *= rope_length / total
    out = np.concatenate([pts, np.full((num_links, 1), z)], axis=1)
    return out.astype(np.float32)


def shape_descriptor(positions_2d: torch.Tensor) -> torch.Tensor:
    """Rope shape descriptor of polylines [..., L, 2] -> [..., 5L - 3]:
    segment-to-segment angles, segment-to-chord angles, midpoint-relative
    vectors and their lengths."""
    vectors = positions_2d[..., 1:, :] - positions_2d[..., :-1, :]
    norms = torch.linalg.vector_norm(vectors, dim=-1, keepdim=True)
    unit = vectors / (norms + 1e-6)

    cos_seg = torch.clamp((unit[..., :-1, :] * unit[..., 1:, :]).sum(dim=-1), -1.0, 1.0)
    ang_seg = torch.arccos(cos_seg)

    first, last = positions_2d[..., :1, :], positions_2d[..., -1:, :]
    gvec = last - first
    gunit = gvec / torch.clamp(torch.linalg.vector_norm(gvec, dim=-1, keepdim=True), min=1e-6)
    cos_glob = torch.clamp((unit * gunit).sum(dim=-1), -1.0, 1.0)
    ang_glob = torch.arccos(cos_glob)

    rel = positions_2d - 0.5 * (first + last)
    rel_dist = torch.linalg.vector_norm(rel, dim=-1)
    return torch.cat([ang_seg, ang_glob, rel.flatten(-2), rel_dist], dim=-1)


def yaw_rotate_2d(points: torch.Tensor, yaw: torch.Tensor) -> torch.Tensor:
    """Rotate [..., N, 3] points about z by per-batch yaw [...]."""
    c, s = torch.cos(yaw)[..., None], torch.sin(yaw)[..., None]
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    return torch.stack([c * x - s * y, s * x + c * y, z], dim=-1)


@dataclasses.dataclass(frozen=True)
class RopeTaskCfg:
    """Same fields and defaults as the reference's `RopeTaskCfg`."""

    name: str = "rope_closing"
    num_envs: int = 40
    num_links: int = 40  # shaping: 80
    rope_length: float = 5.0  # shaping: 10.0
    episode_length: int = 200
    decimation: int = 2
    dt: float = 0.01
    iterations: int = 8
    warmup_steps: int = 10

    link_mass: float = 0.05
    rope_damping: float = 2.0
    gripper_mass: float = 10.0
    gripper_size: Tuple[float, float, float] = (0.1, 0.1, 0.1)
    rope_z: float = 0.1
    ground_z: float = -0.5
    # velocity-pass material; 0 runs no pass
    restitution: float = 0.0
    dynamic_friction_scale: float = 0.0

    # closing scene
    hanger_pos: Tuple[float, float, float] = (2.0, 3.0, 0.0)
    hanger_radius: float = 0.15
    hanger_xy_range: float = 0.5
    around_hanger_yaw: Tuple[float, float] = (-math.pi, math.pi)
    center_rot_range: Tuple[float, float] = (-math.pi / 4, math.pi / 4)

    # shaping; an empty file name selects the procedural `w_shape_curve`
    target_curve_file: str = ""
    target_yaw_range: Tuple[float, float] = (-math.pi / 2, math.pi / 2)
    # the offset between rope and target is drawn from one of two ranges
    shaping_rot_ranges: Tuple[Tuple[float, float], Tuple[float, float]] = (
        (-math.pi / 2, -math.pi / 4),
        (math.pi / 4, math.pi / 2),
    )

    # rewards
    closing_grip_weight: float = -2.0
    closing_grip_last_steps: int = 20
    closing_wrap_weight: float = -0.8
    closing_vel_weight: float = -1e-2
    closing_action_rate_weight: float = -1e-3
    shaping_weight: float = -1.0
    shaping_last_steps: int = 10
    shaping_weight_last: float = 5.0
    shaping_action_rate_weight: float = -1e-4

    action_max: float = 1.0
    action_linear_scale: float = 5.0  # clamp(+-1) * 5.0, z zeroed

    @property
    def num_grippers(self) -> int:
        return 2

    @property
    def action_dim(self) -> int:
        return 3 * self.num_grippers

    @property
    def link_spacing(self) -> float:
        # (length / links - radius): 0.1 for both tasks
        return self.rope_length / self.num_links - 0.025

    @property
    def is_shaping(self) -> bool:
        return self.name == "rope_shaping"


class RopeEnvState(NamedTuple):
    scene: SceneState
    target_yaw: torch.Tensor  # [B] (shaping)
    hanger_xy: torch.Tensor  # [B, 2] randomised hanger position (closing)
    episode_step: torch.Tensor  # [B] int32
    generator: torch.Generator  # draws the fresh layouts of done envs
    prev_action: torch.Tensor  # [B, A]


class RopeEnv:
    """Batched rope-task environment on one device."""

    def __init__(self, cfg: RopeTaskCfg, device="cuda", rows: Optional[Rows] = None):
        """`rows` makes the env one process's row block of a data-parallel
        batch: `cfg.num_envs` of `rows.total` envs, drawing at the global
        width (`parallel.mesh`)."""
        self.cfg = cfg
        self.rows = rows
        self.device = device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("RopeEnv runs on the card by default and torch finds no CUDA device; "
                               "pass device='cpu' to run on the CPU")
        B, L = cfg.num_envs, cfg.num_links

        def t(values, dtype=torch.float32):
            return torch.as_tensor(np.asarray(values), dtype=dtype, device=device)

        self.body_spec = RigidBodySpec(
            inv_mass=torch.full((2,), 1.0 / cfg.gripper_mass, device=device),
            inv_inertia=(1.0 / box_inertia(cfg.gripper_mass, cfg.gripper_size, device)).repeat(2, 1),
            gravity_scale=torch.zeros(2, device=device),  # grippers float
            lin_damping=torch.full((2,), 10.0, device=device),
            ang_damping=torch.full((2,), 10.0, device=device),
            free_pos=t([[1.0, 1.0, 0.0]] * 2),  # z locked
            free_rot=torch.zeros((2, 3), device=device),  # all rotation locked
        )
        self.particle_spec = ParticleSpec(
            inv_mass=torch.full((L,), 1.0 / cfg.link_mass, device=device), lin_damping=cfg.rope_damping
        )
        # chain distance constraints in two conflict-free groups (even / odd)
        idx = np.arange(L - 1)
        self.distance_groups = tuple(
            DistanceGroup(
                i=t(g, torch.int64), j=t(g + 1, torch.int64),
                rest=torch.full((len(g),), cfg.link_spacing, device=device),
                compliance=torch.zeros(len(g), device=device),
            )
            for g in (idx[idx % 2 == 0], idx[idx % 2 == 1])
        )
        self.attachments = attachment_sum_order(BodyAttachment(
            particle=t([0, L - 1], torch.int64), body=t([0, 1], torch.int64), local_pos=torch.zeros((2, 3), device=device)
        ), L, self.body_spec.inv_mass.shape[0])
        if cfg.is_shaping:
            if cfg.target_curve_file:
                curve = load_target_curve(cfg.target_curve_file, L, cfg.rope_length, cfg.rope_z)
                curve = curve - np.concatenate([curve[:, :2].mean(0), [0.0]]).astype(np.float32)
            else:
                curve = w_shape_curve(L, cfg.rope_length, cfg.rope_z)
            self.target_curve = t(curve)
        else:
            self.target_curve = None
        self.obs_spec = self._build_obs_spec()

        # constants of reset and step, made once so neither copies from the host
        x = np.arange(L, dtype=np.float32) * np.float32(cfg.link_spacing)
        links = np.stack([x, np.zeros(L, np.float32), np.full((L,), cfg.rope_z, np.float32)], axis=-1)
        self.rest_links = t(links).expand(B, L, 3)  # straight rope along +x
        self.rest_cubes = self.rest_links[:, [0, L - 1]]  # grippers at the end links
        self.rest_center = self.rest_links.mean(dim=1, keepdim=True)
        self.hanger_origin = t([cfg.hanger_pos[0], cfg.hanger_pos[1], 0.0]).expand(B, 1, 3)
        self.hanger_default_xy = t(cfg.hanger_pos[:2])
        # rotation about the hanger's origin (z = 0) keeps z = rope_z, which
        # this mask writes back exactly
        self.xy_mask = t([1.0, 1.0, 0.0])
        self.rope_z_offset = t([0.0, 0.0, cfg.rope_z])
        self.identity_quat = quat_identity((B, 2), device)
        self.zeros_b = torch.zeros(B, device=device)
        self.zeros_b1 = torch.zeros((B, 1), device=device)
        self.zeros_b2 = torch.zeros((B, 2), device=device)
        self.zeros_cubes = torch.zeros((B, 2, 3), device=device)
        self.zeros_links = torch.zeros((B, L, 3), device=device)
        self.infos = torch.full((B, 1), float(L), device=device)
        self.ground_contact = ParticleSDFContact(
            sdf=lambda p: ground_sdf(p, cfg.ground_z), friction=0.3, restitution=cfg.restitution,
            dynamic_friction=cfg.dynamic_friction_scale * 0.3,
        )

    def _build_obs_spec(self) -> ObsSpec:
        L, G = self.cfg.num_links, 2
        return ObsSpec(
            names={
                "scalars": ["rope_target_distances"],
                "position_vectors": ["grippers", "links", "target_geometry"],
                "velocity_vectors": ["grippers", "links"],
                "infos": ["num_links"],
            },
            dims={
                "scalars": [1],
                "position_vectors": [3 * G, 3 * L, 3 * L],
                "velocity_vectors": [3 * G, 3 * L],
                "infos": [1],
            },
        )

    # ----------------------------------------------------------------- reset

    def _initial_layout(self, generator: torch.Generator):
        """Straight rope along +x, cubes at the ends, then the reset rotations.

        Closing has two reset terms: yaw1 in +-pi/4 about the rope's center,
        applied to the cubes and the rope; then yaw2 in +-pi about the default
        hanger position, applied to the cubes from their term-1 poses but to
        the rope from its default (straight) pose. The rope so loses the first
        rotation, and the pinned cubes bend it during warm-up. The hanger is
        moved by U(+-0.5) in x and y, independently of the rotation's origin.

        Shaping draws the target's yaw and an offset from one of two ranges
        (one uniform serves both: drawn once, mapped into the picked range),
        and rotates rope and cubes about the rope's center by their sum."""
        cfg = self.cfg
        B, dev = cfg.num_envs, self.device

        def uniform(lo, hi, shape=(B,)):
            return draw_rows(lambda s: sample_uniform(generator, lo, hi, s, dev), shape, self.rows)

        def rand():
            return draw_rows(lambda s: torch.rand(s, generator=generator, device=dev), (B,), self.rows)

        links, cubes, center = self.rest_links, self.rest_cubes, self.rest_center
        if cfg.is_shaping:
            target_yaw = uniform(*cfg.target_yaw_range)
            (lo1, hi1), (lo2, hi2) = cfg.shaping_rot_ranges
            pick = rand() < 0.5
            u = rand()
            off = torch.where(pick, u * (hi2 - lo2) + lo2, u * (hi1 - lo1) + lo1)
            angle = target_yaw + off
            hanger_xy = self.zeros_b2
            links = center + yaw_rotate_2d(links - center, angle)
            cubes = center + yaw_rotate_2d(cubes - center, angle)
        else:
            target_yaw = self.zeros_b
            # term 1: the cubes about the rope's center
            cubes = center + yaw_rotate_2d(cubes - center, uniform(*cfg.center_rot_range))
            # term 2: about the default hanger; the rope restarts from its default
            yaw2 = uniform(*cfg.around_hanger_yaw)
            origin = self.hanger_origin
            links = (origin + yaw_rotate_2d(links - origin, yaw2)) * self.xy_mask + self.rope_z_offset
            cubes = (origin + yaw_rotate_2d(cubes - origin, yaw2)) * self.xy_mask + self.rope_z_offset
            hanger_xy = self.hanger_default_xy + uniform(-cfg.hanger_xy_range, cfg.hanger_xy_range, (B, 2))

        scene = SceneState(
            bodies=RigidBodyState(pos=cubes, quat=self.identity_quat, lin_vel=self.zeros_cubes, ang_vel=self.zeros_cubes),
            particles=ParticleState(pos=links, vel=self.zeros_links),
        )
        return scene, target_yaw, hanger_xy

    @spanned("envs.reset")
    def reset(self, generator: torch.Generator) -> RopeEnvState:
        cfg = self.cfg
        scene, target_yaw, hanger_xy = self._initial_layout(generator)
        # zero-action warm-up after the explicit reset (auto-resets inside
        # `step` get none): only the bodies' velocities are zeroed
        for _ in range(cfg.warmup_steps):
            zeroed = scene._replace(bodies=scene.bodies._replace(lin_vel=self.zeros_cubes, ang_vel=self.zeros_cubes))
            scene = self._physics(zeroed, hanger_xy)
        return RopeEnvState(
            scene=scene,
            target_yaw=target_yaw,
            hanger_xy=hanger_xy,
            episode_step=torch.zeros((cfg.num_envs,), dtype=torch.int32, device=self.device),
            generator=generator,
            prev_action=torch.zeros((cfg.num_envs, cfg.action_dim), device=self.device),
        )

    # ------------------------------------------------------------------ step

    def _particle_contacts(self, hanger_xy):
        """The ground and, for closing, the pole at this step's per-env
        hanger position (the SDF closes over `hanger_xy` [B, 2])."""
        cfg = self.cfg
        if cfg.is_shaping:
            return (self.ground_contact,)
        radius = cfg.hanger_radius

        def pole_sdf(points):
            d_xy = points[..., :2] - hanger_xy[:, None, :]
            dist = torch.linalg.vector_norm(d_xy, dim=-1)
            n_xy = d_xy / torch.clamp(dist, min=1e-9)[..., None]
            return dist - radius, torch.cat([n_xy, torch.zeros_like(points[..., :1])], dim=-1)

        pole = ParticleSDFContact(
            sdf=pole_sdf, friction=0.4, restitution=cfg.restitution, dynamic_friction=cfg.dynamic_friction_scale * 0.4
        )
        return (self.ground_contact, pole)

    def _apply_action(self, scene: SceneState, action: torch.Tensor) -> SceneState:
        cfg = self.cfg
        a = torch.clamp(action, -cfg.action_max, cfg.action_max)
        # per gripper: xy scaled, the z command zeroed
        lin = a.reshape(a.shape[0], 2, 3) * (cfg.action_linear_scale * self.xy_mask)
        return scene._replace(bodies=scene.bodies._replace(lin_vel=lin))

    def _physics(self, scene: SceneState, hanger_xy) -> SceneState:
        cfg = self.cfg
        return step_physics(
            scene, self.body_spec, cfg.dt, cfg.decimation, particle_spec=self.particle_spec,
            distance_groups=self.distance_groups, attachments=self.attachments,
            particle_contacts=self._particle_contacts(hanger_xy), iterations=cfg.iterations,
        )

    def _target_points(self, state: RopeEnvState) -> torch.Tensor:
        cfg = self.cfg
        B, L = cfg.num_envs, cfg.num_links
        if cfg.is_shaping:
            return yaw_rotate_2d(self.target_curve.expand(B, L, 3), state.target_yaw)
        hanger = torch.cat([state.hanger_xy, self.zeros_b1], dim=-1)
        return hanger[:, None, :].expand(B, L, 3)

    def _observe(self, state: RopeEnvState) -> Dict[str, torch.Tensor]:
        B = self.cfg.num_envs
        bodies, parts = state.scene.bodies, state.scene.particles
        target = self._target_points(state).reshape(B, -1)
        return {
            "scalars": self.zeros_b1,
            "position_vectors": torch.cat([bodies.pos.reshape(B, -1), parts.pos.reshape(B, -1), target], dim=-1),
            "velocity_vectors": torch.cat([bodies.lin_vel.reshape(B, -1), parts.vel.reshape(B, -1)], dim=-1),
            "infos": self.infos,
        }

    def _shape_error(self, state: RopeEnvState) -> torch.Tensor:
        """Mean squared shape-descriptor difference between rope and target [B]."""
        cur = shape_descriptor(state.scene.particles.pos[..., :2])
        tgt = shape_descriptor(self._target_points(state)[..., :2])
        return ((cur - tgt) ** 2).mean(dim=-1)

    def _reward(self, state: RopeEnvState, action: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        act_rate = ((action - state.prev_action) ** 2).sum(dim=-1)
        if cfg.is_shaping:
            dist = self._shape_error(state)
            in_last = state.episode_step >= cfg.episode_length - cfg.shaping_last_steps
            dist = torch.where(in_last, dist * cfg.shaping_weight_last, dist)
            return cfg.shaping_weight * dist + cfg.shaping_action_rate_weight * act_rate
        # closing
        grip = state.scene.bodies.pos
        grip_dist = torch.linalg.vector_norm(grip[:, 0, :2] - grip[:, 1, :2], dim=-1)
        in_last = state.episode_step >= cfg.episode_length - cfg.closing_grip_last_steps
        grip_term = torch.where(in_last, grip_dist, 0.0)
        centroid = state.scene.particles.pos[..., :2].mean(dim=1)
        wrap = torch.linalg.vector_norm(state.hanger_xy - centroid, dim=-1)
        vel = torch.linalg.vector_norm(state.scene.particles.vel, dim=-1).mean(dim=-1)
        return (
            cfg.closing_grip_weight * grip_term
            + cfg.closing_wrap_weight * wrap
            + cfg.closing_vel_weight * vel
            + cfg.closing_action_rate_weight * act_rate
        )

    @spanned("envs.step")
    def step(self, state: RopeEnvState, action: torch.Tensor) -> Tuple[RopeEnvState, TimeStep]:
        cfg = self.cfg
        with span("envs.action"):
            scene = self._apply_action(state.scene, action)
        with span("envs.physics"):
            scene = self._physics(scene, state.hanger_xy)
        stepped = state._replace(scene=scene, episode_step=state.episode_step + 1)

        with span("envs.reward"):
            reward = self._reward(stepped, action)
            done = stepped.episode_step >= cfg.episode_length

        # done envs restart from a fresh layout, drawn for every env on every
        # step (no warm-up on auto-reset, as in the reference)
        with span("envs.reset_draw"):
            fresh, fresh_yaw, fresh_hxy = self._initial_layout(state.generator)
            d1, d3 = done[:, None], done[:, None, None]
            new_state = RopeEnvState(
                scene=SceneState(
                    bodies=RigidBodyState(*(torch.where(d3, f, s) for f, s in zip(fresh.bodies, scene.bodies))),
                    particles=ParticleState(*(torch.where(d3, f, s) for f, s in zip(fresh.particles, scene.particles))),
                ),
                target_yaw=torch.where(done, fresh_yaw, stepped.target_yaw),
                hanger_xy=torch.where(d1, fresh_hxy, stepped.hanger_xy),
                episode_step=torch.where(done, 0, stepped.episode_step).to(torch.int32),
                generator=state.generator,
                prev_action=torch.where(d1, 0.0, action),
            )
        with span("envs.observe"):
            obs = self._observe(new_state)
            # success metric on the pre-reset state: closing -> the grippers'
            # planar gap; shaping -> RMS shape-descriptor error against the target
            if cfg.is_shaping:
                task_dist = torch.sqrt(self._shape_error(stepped))
            else:
                grip = scene.bodies.pos
                task_dist = torch.linalg.vector_norm(grip[:, 0, :2] - grip[:, 1, :2], dim=-1)
        info = {"episode_step": new_state.episode_step, "object_target_distance": task_dist}
        return new_state, TimeStep(obs=obs, reward=reward, done=done, info=info)

    def observe(self, state: RopeEnvState) -> Dict[str, torch.Tensor]:
        return self._observe(state)


def rope_closing_cfg(num_envs: int = 40, **kw) -> RopeTaskCfg:
    kw.setdefault("num_links", 40)
    kw.setdefault("rope_length", 5.0)
    return RopeTaskCfg(name="rope_closing", num_envs=num_envs, **kw)


def rope_shaping_cfg(num_envs: int = 40, **kw) -> RopeTaskCfg:
    kw.setdefault("num_links", 80)
    kw.setdefault("rope_length", 10.0)
    return RopeTaskCfg(name="rope_shaping", num_envs=num_envs, **kw)
