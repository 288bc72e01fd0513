"""Cloth hanging task: hang a holed cloth onto a hook.

Port of `geometry_rl_tpu/envs/cloth.py`: a 15x15 XPBD particle cloth with a
per-env hole (a particle/constraint mask over a static grid, 20 train
placements round-robin over envs), 4 gripper cubes attached at the corners,
and a capsule hook. Episode 100 steps, decimation 2.

In the kernel modes the position solve runs through `sim/cloth_solve.py`:
for CUDA tensors the kernel of the solver mode (K2's port for "auto"/"tiled",
K1's for True), for CPU tensors the plain version. `use_pallas_solver=False`
(and "auto" with the velocity-pass material on) is the reference's other
solver: `sim/xpbd.step_physics` with the grippers as real bodies, the corner
attachments, the hook capsule as a particle contact and the optional self
contact. It launches neither kernel, and no kernel mode ever lands in it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..parallel.mesh import Rows, draw_rows
from ..sim.cloth_solve import ClothSolveSpec, cloth_position_solve, pack_groups
from ..sim.types import ParticleState, RigidBodySpec, RigidBodyState, SceneState, box_inertia
from ..sim.xpbd import (
    GRAVITY,
    BodyAttachment,
    DistanceGroup,
    ParticleSDFContact,
    ParticleSelfContact,
    ParticleSpec,
    attachment_sum_order,
    step_physics,
)
from ..utils.math import quat_apply, quat_from_euler_xyz, quat_identity, sample_uniform
from .base import ObsSpec, TimeStep

N_ROW = 15  # num_particles_per_row
N_PARTICLES = N_ROW * N_ROW
K_BOUNDARY = 10  # closest boundary nodes of the hole


def grid_index(r: int, c: int) -> int:
    return r * N_ROW + c


def sample_hole_placements(num_holes: int = 40, max_offset: int = 3, seed: int = 2):
    """Hole-center placements around the cloth center: integer grid offsets
    within +-3, deduplicated, deterministic order."""
    import random as _random

    rng = _random.Random(seed)
    center = N_ROW // 2
    combos = set()
    while len(combos) < num_holes:
        x = rng.randint(center - max_offset, center + max_offset)
        y = rng.randint(center - max_offset, center + max_offset)
        combos.add((x, y))
    return list(combos)


def build_hole_variant(hole_rc: Tuple[int, int], radius_grid: float = 1.1):
    """For one hole placement: (removed-particle mask [P], boundary indices
    [K_BOUNDARY]). Vertices within `radius_grid` grid units of the hole center
    are removed; the boundary is the K closest remaining vertices."""
    hr, hc = hole_rc
    rows, cols = np.meshgrid(np.arange(N_ROW), np.arange(N_ROW), indexing="ij")
    d = np.sqrt((rows - hr) ** 2 + (cols - hc) ** 2).reshape(-1)
    removed = d <= radius_grid
    order = np.argsort(np.where(removed, np.inf, d))
    boundary = order[:K_BOUNDARY]
    return removed.astype(np.float32), boundary.astype(np.int32)


def grid_constraints():
    """Grid distance-constraint index lists by family with conflict-free
    groups: stretch (axis edges), shear (diagonals), bend (skip-one)."""

    def pairs(dr, dc):
        out = []
        for r in range(N_ROW):
            for c in range(N_ROW):
                r2, c2 = r + dr, c + dc
                if 0 <= r2 < N_ROW and 0 <= c2 < N_ROW:
                    out.append((grid_index(r, c), grid_index(r2, c2)))
        return np.asarray(out, np.int64)

    # conflict-free split: alternate on the marching coordinate
    def split(p, axis_vals, step):
        even = p[axis_vals % (2 * step) < step]
        odd = p[axis_vals % (2 * step) >= step]
        return [even, odd]

    groups = []
    p = pairs(0, 1)
    groups += [("stretch", g) for g in split(p, (p[:, 0] % N_ROW), 1)]
    p = pairs(1, 0)
    groups += [("stretch", g) for g in split(p, (p[:, 0] // N_ROW), 1)]
    for dr, dc in ((1, 1), (1, -1)):
        p = pairs(dr, dc)
        groups += [("shear", g) for g in split(p, (p[:, 0] // N_ROW), 1)]
    p = pairs(0, 2)
    groups += [("bend", g) for g in split(p, (p[:, 0] % N_ROW), 2)]
    p = pairs(2, 0)
    groups += [("bend", g) for g in split(p, (p[:, 0] // N_ROW), 2)]
    return groups


@dataclasses.dataclass(frozen=True)
class ClothTaskCfg:
    """Same fields and defaults as the reference's `ClothTaskCfg`."""

    name: str = "cloth_hanging"
    num_envs: int = 40
    num_holes: int = 20
    hole_split: str = "train"  # train | test
    # "auto" and "tiled" solve through K2's port (csrc/cloth_solve.cu), True
    # through K1's (csrc/cloth_solve_env.cu), False through sim/xpbd.py's
    # step_physics; "auto" with the material below on goes to False
    use_pallas_solver: object = "auto"
    episode_length: int = 100
    decimation: int = 2
    dt: float = 0.01
    iterations: int = 10
    warmup_steps: int = 10

    cloth_size: float = 1.0
    cloth_mass: float = 0.05
    cloth_damping: float = 1.0
    stretch_compliance: float = 5e-7
    shear_compliance: float = 1e-2
    bend_compliance: float = 1.0
    self_collision: bool = False
    self_collision_distance: Optional[float] = None  # default 2*restOffset
    restitution: float = 0.0
    dynamic_friction_scale: float = 0.0

    gripper_mass: float = 10.0
    gripper_size: Tuple[float, float, float] = (0.1, 0.1, 0.1)

    cloth_center: Tuple[float, float, float] = (0.0, 0.0, 4.5)
    hanger_pos: Tuple[float, float, float] = (0.0, -1.5, 4.5)
    hanger_radius: float = 0.08
    hanger_half_len: float = 0.5
    hanger_xz_range: float = 0.5
    roll_range: Tuple[float, float] = (-math.pi / 4, math.pi / 2)
    pitch_range: Tuple[float, float] = (-math.pi / 2, math.pi / 2)
    yaw_range: Tuple[float, float] = (-math.pi, math.pi)
    spin_range: Tuple[float, float] = (-math.pi, math.pi)

    tracking_weight: float = -0.8
    distortion_area_based: bool = False
    n_last_steps: int = 2
    weight_n_last_steps: float = 5.0
    orientation_weight: float = 0.1
    velocity_weight: float = -0.2
    distortion_weight: float = -1.0
    action_rate_weight: float = -2e-3

    action_max: float = 1.0
    action_scale: float = 2.0

    @property
    def num_grippers(self) -> int:
        return 4

    @property
    def action_dim(self) -> int:
        return 3 * self.num_grippers

    @property
    def spacing(self) -> float:
        return self.cloth_size / (N_ROW - 1)


class ClothEnvState(NamedTuple):
    scene: SceneState
    hanger_pos: torch.Tensor  # [B, 3]
    episode_step: torch.Tensor  # [B] int32
    generator: torch.Generator  # draws the fresh layouts of done envs
    prev_action: torch.Tensor  # [B, A]


class ClothEnv:
    def __init__(self, cfg: ClothTaskCfg, device="cuda", rows: Optional[Rows] = None):
        """`rows` makes the env one process's row block of a data-parallel
        batch: `cfg.num_envs` of `rows.total` envs, drawing at the global
        width (`parallel.mesh`)."""
        self.cfg = cfg
        self.rows = rows
        self.device = device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ClothEnv runs on the card by default and torch finds no CUDA device; "
                               "pass device='cpu' to run on the CPU")
        B = cfg.num_envs

        mode = cfg.use_pallas_solver
        material_on = cfg.restitution > 0.0 or cfg.dynamic_friction_scale > 0.0
        if mode not in ("auto", "tiled", True, False):
            raise ValueError(f"use_pallas_solver must be 'auto', 'tiled', True or False, got {mode!r}")
        if mode == "auto":
            mode = False if material_on else "tiled"
        elif mode and material_on:
            raise ValueError(
                "use_pallas_solver is incompatible with the velocity-pass material "
                "(restitution/dynamic_friction_scale): the fused kernel implements the "
                "position solve only. Use use_pallas_solver=false (or 'auto')."
            )
        # the reference's values: "tiled" runs K2's port, True runs K1's,
        # False runs step_physics
        self.solver_mode = mode

        def t(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        # --- hole variants (TRAIN first 20 of the 40 placements, TEST next 20)
        all_placements = sample_hole_placements()
        if cfg.hole_split == "train":
            placements = all_placements[: cfg.num_holes]
        elif cfg.hole_split == "test":
            placements = all_placements[20 : 20 + cfg.num_holes]
        else:
            raise ValueError(f"hole_split must be train|test, got {cfg.hole_split!r}")
        removed, boundary = zip(*(build_hole_variant(p) for p in placements))
        env_index = np.arange(B) + (0 if rows is None else rows.index.start)  # global env indices
        removed = np.stack(removed)[env_index % cfg.num_holes]  # [B, P]
        boundary = np.stack(boundary)[env_index % cfg.num_holes]  # [B, K]
        self.hole_mask = t(removed)  # 1 = removed
        self.boundary_idx = t(boundary, torch.int64)

        # --- local cloth layout (vertical sheet in the xz plane) ------------
        s = cfg.spacing
        r, c = np.meshgrid(np.arange(N_ROW), np.arange(N_ROW), indexing="ij")
        x = (c - (N_ROW - 1) / 2) * s
        z = ((N_ROW - 1) / 2 - r) * s
        local = np.stack([x, np.zeros_like(x), z], axis=-1).reshape(-1, 3).astype(np.float32)
        self.local_particles = t(local)  # [P, 3]
        self.init_particles = t(local + np.asarray(cfg.cloth_center, np.float32))
        corners = [grid_index(0, 0), grid_index(0, N_ROW - 1), grid_index(N_ROW - 1, 0), grid_index(N_ROW - 1, N_ROW - 1)]
        self.corner_indices = t(corners, torch.int32)

        # --- constraints ------------------------------------------------------
        compliance_of = {"stretch": cfg.stretch_compliance, "shear": cfg.shear_compliance, "bend": cfg.bend_compliance}
        groups, edge_list = [], []
        for family, pairs in grid_constraints():
            i, j = pairs[:, 0], pairs[:, 1]
            rest = np.linalg.norm(local[i] - local[j], axis=-1).astype(np.float32)
            valid = (1.0 - removed[:, i]) * (1.0 - removed[:, j])  # [B, C]
            groups.append(
                DistanceGroup(
                    i=t(i, torch.int32), j=t(j, torch.int32), rest=t(rest),
                    compliance=torch.full((len(i),), compliance_of[family], device=device), mask=t(valid),
                )
            )
            if family in ("stretch", "shear"):
                edge_list.append((pairs, valid))
        self.distance_groups = tuple(groups)

        # triangles for the area-based distortion variant (two per grid quad)
        tris = []
        for r in range(N_ROW - 1):
            for c in range(N_ROW - 1):
                a, b_, c_, d_ = grid_index(r, c), grid_index(r, c + 1), grid_index(r + 1, c), grid_index(r + 1, c + 1)
                tris += [(a, b_, c_), (b_, d_, c_)]
        tris = np.asarray(tris, np.int64)
        self.triangles = t(tris, torch.int64)
        self.tri_mask = t((1.0 - removed[:, tris[:, 0]]) * (1.0 - removed[:, tris[:, 1]]) * (1.0 - removed[:, tris[:, 2]]))
        tri_rest = 0.5 * np.linalg.norm(np.cross(local[tris[:, 1]] - local[tris[:, 0]], local[tris[:, 2]] - local[tris[:, 0]]), axis=-1)
        self.tri_rest_area = t(tri_rest.astype(np.float32))

        # static obs edge set (stretch + shear mesh edges)
        all_edges = np.concatenate([e for e, _ in edge_list], axis=0)  # [E, 2]
        self.obs_edges = t(all_edges, torch.int64)
        self.obs_edge_mask = t(np.concatenate([v for _, v in edge_list], axis=1))  # [B, E]
        self.obs_edge_rest = t(np.linalg.norm(local[all_edges[:, 0]] - local[all_edges[:, 1]], axis=-1).astype(np.float32))
        self.obs_edges_flat = self.obs_edges.reshape(-1).float().expand(B, -1)

        # --- bodies (4 gripper cubes) -----------------------------------------
        G = cfg.num_grippers
        self.body_spec = RigidBodySpec(
            inv_mass=torch.full((G,), 1.0 / cfg.gripper_mass, device=device),
            inv_inertia=(1.0 / box_inertia(cfg.gripper_mass, cfg.gripper_size, device)).repeat(G, 1),
            gravity_scale=torch.zeros(G, device=device),
            lin_damping=torch.full((G,), 10.0, device=device),
            ang_damping=torch.full((G,), 10.0, device=device),
            free_pos=torch.ones((G, 3), device=device),
            free_rot=torch.zeros((G, 3), device=device),
        )
        # removed particles get inv_mass 0 and no constraints
        inv_m = N_PARTICLES / cfg.cloth_mass
        self.particle_spec = ParticleSpec(
            inv_mass=torch.where(self.hole_mask > 0.5, 0.0, inv_m), lin_damping=cfg.cloth_damping
        )
        self.attachments = attachment_sum_order(BodyAttachment(
            particle=self.corner_indices,
            body=torch.arange(G, dtype=torch.int32, device=device),
            local_pos=torch.zeros((G, 3), device=device),
        ), N_PARTICLES, self.body_spec.inv_mass.shape[0])

        # --- self-collision (optional) ------------------------------------------
        self.self_contacts: Tuple[ParticleSelfContact, ...] = ()
        if cfg.self_collision:
            rr, cc = np.divmod(np.arange(N_PARTICLES), N_ROW)
            cheb = np.maximum(np.abs(rr[:, None] - rr[None, :]), np.abs(cc[:, None] - cc[None, :]))
            min_dist = cfg.self_collision_distance
            if min_dist is None:
                min_dist = cfg.cloth_size / (N_ROW + 1)  # 2 * restOffset
            self.self_contacts = (
                ParticleSelfContact(min_dist=float(min_dist), pair_mask=t((cheb > 1).astype(np.float32)), active=1.0 - self.hole_mask),
            )

        self.obs_spec = self._build_obs_spec()

        # --- fused position solve operands -----------------------------------
        self.solve_spec = ClothSolveSpec(
            group_sizes=tuple(int(g.i.shape[0]) for g in self.distance_groups),
            group_compliance=tuple(float(g.compliance[0]) for g in self.distance_groups),
            num_particles=N_PARTICLES,
            num_bodies=G,
            iterations=cfg.iterations,
            dt=cfg.dt,
            hook_radius=cfg.hanger_radius,
            hook_half_len=cfg.hanger_half_len,
            hook_friction=0.2,
            self_min_dist=float(self.self_contacts[0].min_dist) if self.self_contacts else 0.0,
        )
        topo = []
        for g in self.distance_groups:
            topo += [g.i, g.j, g.rest]
        # pack_groups raises unless every group is conflict-free, which the
        # kernel relies on to solve a group's constraints in parallel
        self.groups = pack_groups(self.solve_spec, topo, [g.mask for g in self.distance_groups])
        if self.self_contacts:
            sc = self.self_contacts[0]
            self.self_pair_mask_full = torch.nn.functional.pad(sc.pair_mask, (0, G, 0, G)).contiguous()
            self.self_active_full = torch.nn.functional.pad(sc.active, (0, G)).contiguous()
        else:
            self.self_pair_mask_full = self.self_active_full = None
        self.inv_all = torch.cat([self.particle_spec.inv_mass, self.body_spec.inv_mass.expand(B, G)], dim=1).contiguous()
        self.att_body_w = self.body_spec.inv_mass.expand(B, G).contiguous()
        self.gravity_dv = (cfg.dt * torch.tensor(GRAVITY, device=device) * (self.particle_spec.inv_mass > 0)[..., None]).contiguous()
        # constants of the reset and the substep, made once: a tensor made from
        # host values on the card is a copy that synchronises with the host
        self.hanger_base = torch.tensor(cfg.hanger_pos, device=device)
        self.cloth_center = torch.tensor(cfg.cloth_center, device=device)
        self.body_lin_damp = torch.exp(-self.body_spec.lin_damping * cfg.dt)[:, None]  # [G, 1]
        self.part_damp = torch.exp(torch.tensor(-self.particle_spec.lin_damping * cfg.dt, device=device))

    def _build_obs_spec(self) -> ObsSpec:
        E = self.obs_edges.shape[0]
        G, P, K = self.cfg.num_grippers, N_PARTICLES, K_BOUNDARY
        return ObsSpec(
            names={
                "scalars": ["hole_target_distances", "cloth_edges_length"],
                "position_vectors": ["grippers", "particles", "init_particles", "hole_boundary", "target_hook"],
                "velocity_vectors": ["grippers", "particles"],
                "infos": ["hole_boundary_indices"],
            },
            dims={
                "scalars": [K, 2 * E],
                "position_vectors": [3 * G, 3 * P, 3 * P, 3 * K, 3],
                "velocity_vectors": [3 * G, 3 * P],
                "infos": [K],
            },
        )

    # ----------------------------------------------------------------- reset

    def _initial_layout(self, generator: torch.Generator):
        cfg = self.cfg
        B, P, G = cfg.num_envs, N_PARTICLES, cfg.num_grippers
        dev = self.device
        zeros = torch.zeros(B, device=dev)

        def uniform(lo, hi):
            return draw_rows(lambda s: sample_uniform(generator, lo, hi, s, dev), (B,), self.rows)

        hanger = self.hanger_base + torch.stack(
            [uniform(-cfg.hanger_xz_range, cfg.hanger_xz_range), zeros, uniform(-cfg.hanger_xz_range, cfg.hanger_xz_range)],
            dim=-1,
        )
        center = self.cloth_center
        particles = self.init_particles.expand(B, P, 3)
        cubes = particles[:, self.corner_indices.long()]

        # spin the cloth in its own plane about the y axis through its center
        q_spin = quat_from_euler_xyz(zeros, uniform(*cfg.spin_range), zeros)
        particles = center + quat_apply(q_spin[:, None, :], particles - center)
        cubes = center + quat_apply(q_spin[:, None, :], cubes - center)

        # rotate cloth + cubes around the hanger
        roll, pitch, yaw = uniform(*cfg.roll_range), uniform(*cfg.pitch_range), uniform(*cfg.yaw_range)
        q = quat_from_euler_xyz(roll, pitch, yaw)
        particles = hanger[:, None] + quat_apply(q[:, None, :], particles - hanger[:, None])
        cubes = hanger[:, None] + quat_apply(q[:, None, :], cubes - hanger[:, None])

        scene = SceneState(
            bodies=RigidBodyState(
                pos=cubes,
                quat=quat_identity((B, G), dev).clone(),
                lin_vel=torch.zeros((B, G, 3), device=dev),
                ang_vel=torch.zeros((B, G, 3), device=dev),
            ),
            particles=ParticleState(pos=particles, vel=torch.zeros((B, P, 3), device=dev)),
        )
        return scene, hanger

    def reset(self, generator: torch.Generator) -> ClothEnvState:
        cfg = self.cfg
        scene, hanger = self._initial_layout(generator)
        state = ClothEnvState(
            scene=scene,
            hanger_pos=hanger,
            episode_step=torch.zeros((cfg.num_envs,), dtype=torch.int32, device=self.device),
            generator=generator,
            prev_action=torch.zeros((cfg.num_envs, cfg.action_dim), device=self.device),
        )
        for _ in range(cfg.warmup_steps):
            zero_vel = torch.zeros_like(state.scene.bodies.lin_vel)
            scene = state.scene._replace(bodies=state.scene.bodies._replace(lin_vel=zero_vel, ang_vel=zero_vel))
            state = state._replace(scene=self._physics(scene, state.hanger_pos))
        return state

    # ------------------------------------------------------------------ step

    def _apply_action(self, scene: SceneState, action: torch.Tensor) -> SceneState:
        cfg = self.cfg
        a = torch.clamp(action, -cfg.action_max, cfg.action_max)
        lin = (a * cfg.action_scale).reshape(a.shape[0], cfg.num_grippers, 3)
        return scene._replace(bodies=scene.bodies._replace(lin_vel=lin))

    def _hanger_contacts(self, hanger_pos):
        cfg = self.cfg

        def hook_sdf(points):
            """Capsule along +y from the hanger origin."""
            rel = points - hanger_pos[:, None, :]
            y = torch.clamp(rel[..., 1], 0.0, 2 * cfg.hanger_half_len)
            zero = torch.zeros_like(y)
            d = rel - torch.stack([zero, y, zero], dim=-1)
            dist = torch.linalg.vector_norm(d, dim=-1)
            return dist - cfg.hanger_radius, d / torch.clamp(dist, min=1e-9)[..., None]

        return (
            ParticleSDFContact(
                sdf=hook_sdf, friction=0.2, restitution=cfg.restitution,
                dynamic_friction=cfg.dynamic_friction_scale * 0.2,
            ),
        )

    def _physics(self, scene: SceneState, hanger_pos) -> SceneState:
        cfg = self.cfg
        if self.solver_mode:
            return self._physics_pallas(scene, hanger_pos)
        return step_physics(
            scene, self.body_spec, cfg.dt, cfg.decimation, particle_spec=self.particle_spec,
            distance_groups=self.distance_groups, attachments=self.attachments,
            particle_contacts=self._hanger_contacts(hanger_pos), self_contacts=self.self_contacts,
            iterations=cfg.iterations,
        )

    def _physics_pallas(self, scene: SceneState, hanger_pos) -> SceneState:
        """Decimation substeps, each one fused position solve (the name keeps
        the reference's; the solve is `sim/cloth_solve.py`)."""
        cfg = self.cfg
        dt = cfg.dt
        P = N_PARTICLES
        body_lin_damp, part_damp = self.body_lin_damp, self.part_damp
        hanger_pos = hanger_pos.contiguous()
        for _ in range(cfg.decimation):
            bodies, parts = scene.bodies, scene.particles
            # integrate (grippers have gravity_scale 0)
            prev_b = bodies.pos
            pos_b = bodies.pos + dt * (bodies.lin_vel * body_lin_damp)
            pv = (parts.vel + self.gravity_dv) * part_damp
            prev_p = parts.pos
            x_p = parts.pos + dt * pv

            x = torch.cat([x_p, pos_b], dim=1)
            prev_x = torch.cat([prev_p, prev_b], dim=1)
            x = cloth_position_solve(
                self.solve_spec, x, prev_x, self.inv_all, hanger_pos, self.att_body_w,
                self.corner_indices, self.groups, self.self_pair_mask_full, self.self_active_full,
                kernel="tiled" if self.solver_mode == "tiled" else "per_env",
            )
            new_p, new_b = x[:, :P], x[:, P:]
            scene = SceneState(
                bodies=bodies._replace(pos=new_b, lin_vel=(new_b - prev_b) / dt, ang_vel=torch.zeros_like(bodies.ang_vel)),
                particles=ParticleState(pos=new_p, vel=(new_p - prev_p) / dt),
            )
        return scene

    # ------------------------------------------------------------- obs/reward

    def _hole_centroid(self, particles: torch.Tensor) -> torch.Tensor:
        """Mean of the K boundary nodes."""
        return self._boundary(particles).mean(dim=1)

    def _boundary(self, particles: torch.Tensor) -> torch.Tensor:
        idx = self.boundary_idx[..., None].expand(-1, -1, 3)
        return torch.gather(particles, 1, idx)  # [B, K, 3]

    def _edge_lengths(self, particles: torch.Tensor) -> torch.Tensor:
        e = self.obs_edges
        return torch.linalg.vector_norm(particles[:, e[:, 0]] - particles[:, e[:, 1]], dim=-1)  # [B, E]

    def _observe(self, state: ClothEnvState) -> Dict[str, torch.Tensor]:
        B = self.cfg.num_envs
        parts = state.scene.particles.pos
        boundary = self._boundary(parts)
        hanger = state.hanger_pos
        hole_dists = torch.linalg.vector_norm(boundary - hanger[:, None], dim=-1)  # [B, K]
        init_parts = self.init_particles.reshape(1, -1).expand(B, -1)
        return {
            "scalars": torch.cat([hole_dists, self.obs_edges_flat], dim=-1),
            "position_vectors": torch.cat(
                [state.scene.bodies.pos.reshape(B, -1), parts.reshape(B, -1), init_parts, boundary.reshape(B, -1), hanger],
                dim=-1,
            ),
            "velocity_vectors": torch.cat(
                [state.scene.bodies.lin_vel.reshape(B, -1), state.scene.particles.vel.reshape(B, -1)], dim=-1
            ),
            "infos": self.boundary_idx.float(),
        }

    def _reward(self, state: ClothEnvState, action: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        parts = state.scene.particles.pos
        dvec = self._hole_centroid(parts) - state.hanger_pos
        distance = torch.linalg.vector_norm(dvec, dim=-1)
        # orientation: the hole should sit on the +y side of the hook
        unit = dvec / torch.clamp(distance, min=1e-9)[..., None]
        ori = torch.abs(unit[..., 1] - 1.0)

        in_last = state.episode_step >= cfg.episode_length - cfg.n_last_steps
        w = torch.where(in_last, cfg.weight_n_last_steps, 1.0)
        tracking = w * distance + cfg.orientation_weight * (w * ori)

        vel = torch.linalg.vector_norm(state.scene.particles.vel, dim=-1).mean(dim=-1)

        if cfg.distortion_area_based:
            tri = self.triangles
            v1 = parts[:, tri[:, 1]] - parts[:, tri[:, 0]]
            v2 = parts[:, tri[:, 2]] - parts[:, tri[:, 0]]
            areas = 0.5 * torch.linalg.vector_norm(torch.linalg.cross(v1, v2, dim=-1), dim=-1)
            deviation = torch.abs((areas - self.tri_rest_area) / self.tri_rest_area)
            distortion = (deviation * self.tri_mask).sum(-1) / torch.clamp(self.tri_mask.sum(-1), min=1.0)
        else:
            deviation = torch.abs((self._edge_lengths(parts) - self.obs_edge_rest) / self.obs_edge_rest)
            distortion = (deviation * self.obs_edge_mask).sum(-1) / torch.clamp(self.obs_edge_mask.sum(-1), min=1.0)

        act_rate = torch.sum((action - state.prev_action) ** 2, dim=-1)
        return (
            cfg.tracking_weight * tracking
            + cfg.velocity_weight * vel
            + cfg.distortion_weight * distortion
            + cfg.action_rate_weight * act_rate
        )

    def step(self, state: ClothEnvState, action: torch.Tensor) -> Tuple[ClothEnvState, TimeStep]:
        cfg = self.cfg
        scene = self._apply_action(state.scene, action)
        scene = self._physics(scene, state.hanger_pos)
        stepped = state._replace(scene=scene, episode_step=state.episode_step + 1)

        reward = self._reward(stepped, action)
        done = stepped.episode_step >= cfg.episode_length

        # done envs restart from a fresh layout (drawn every step, as the
        # reference does, so the generator advances the same way)
        fresh, fresh_hanger = self._initial_layout(state.generator)
        d1, d3 = done[:, None], done[:, None, None]
        new_scene = SceneState(
            bodies=RigidBodyState(*(torch.where(d3, f, s) for f, s in zip(fresh.bodies, scene.bodies))),
            particles=ParticleState(*(torch.where(d3, f, s) for f, s in zip(fresh.particles, scene.particles))),
        )
        new_state = ClothEnvState(
            scene=new_scene,
            hanger_pos=torch.where(d1, fresh_hanger, stepped.hanger_pos),
            episode_step=torch.where(done, 0, stepped.episode_step).to(torch.int32),
            generator=state.generator,
            prev_action=torch.where(d1, 0.0, action),
        )
        obs = self._observe(new_state)
        # success metric: hole centroid -> hook distance at this step (pre-reset)
        hole_dist = torch.linalg.vector_norm(self._hole_centroid(stepped.scene.particles.pos) - stepped.hanger_pos, dim=-1)
        return new_state, TimeStep(
            obs=obs,
            reward=reward,
            done=done,
            info={"episode_step": new_state.episode_step, "object_target_distance": hole_dist},
        )

    def observe(self, state: ClothEnvState) -> Dict[str, torch.Tensor]:
        return self._observe(state)


def cloth_hanging_cfg(num_envs: int = 40, **kw) -> ClothTaskCfg:
    return ClothTaskCfg(name="cloth_hanging", num_envs=num_envs, **kw)
