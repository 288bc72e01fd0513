"""Rigid manipulation tasks: pushing, sliding, insertion, two-agent insertion
(port of `geometry_rl_tpu/envs/rigid.py`).

One `RigidEnv`, parameterised by `RigidTaskCfg`, covers the four task
registrations. Env e uses shape e % S of the padded shape set (round-robin
multi-asset assignment). Scene bodies per env: [grippers (G), object,
target (static marker), plate (insertion only, static)].

`step` draws fresh poses for every env on every step and selects those of
the envs that finished with `torch.where`; it reads nothing back to the host,
so a rollout on the card stays asynchronous. `restitution` and
`dynamic_friction_scale` reach every contact (the dynamic coefficient is the
scale times the contact's static one) and turn on the XPBD velocity pass;
both default to 0, which runs none.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..parallel.mesh import Rows, draw_rows
from ..sim.shapes import PUSHING_SHAPE_NAMES, SHAPE_NAMES, ShapeSet, build_shape_set, ground_sdf, hole_plate_sdf, polygon_sdf_2d
from ..sim.types import FixedJointSpec, RigidBodySpec, RigidBodyState, SceneState, box_inertia
from ..sim.xpbd import BodyPairContact, ContactSet, joint_sum_order, with_bodies, step_physics
from ..utils.math import (
    quat_apply,
    quat_conjugate,
    quat_error_magnitude,
    quat_from_euler_xyz,
    quat_mul,
    sample_uniform,
    transform_points,
)
from .base import ObsSpec, TimeStep


@dataclasses.dataclass(frozen=True)
class RigidTaskCfg:
    """Static task parameters; the same fields and defaults (insertion) as
    the reference's `RigidTaskCfg`."""

    name: str = "rigid_insertion"
    num_envs: int = 40
    shapes: Tuple[str, ...] = SHAPE_NAMES
    episode_length: int = 100  # control steps
    decimation: int = 4
    dt: float = 0.01
    warmup_steps: int = 5  # zero-action steps after reset
    iterations: int = 8  # solver position iterations

    # geometry
    shape_scale: float = 0.1
    shape_half_height: float = 0.05
    hole_clearance: float = 0.08
    plate_half_extent: float = 0.4
    plate_half_thickness: float = 0.05
    gripper_size: Tuple[float, float, float] = (0.025, 0.025, 0.5)

    # actions
    num_grippers: int = 1
    linear_only: bool = False
    z_action: bool = True
    rotation_axis: int = 2  # -1 = all axes
    action_linear_scale: float = 1.0
    action_angular_scale: float = 20.0
    action_max: float = 1.0

    # bodies
    attached: bool = True  # weld gripper(s) to object
    object_mass: float = 0.1
    object_lin_damping: float = 10.0
    object_ang_damping: float = 2.0
    object_free_pos_bits: int = 0  # locked_pos_axis bits
    object_free_rot_bits: int = 3  # locked_rot_axis bits
    gripper_mass: float = 10.0
    gripper_damping: float = 10.0
    gripper_locked_rot_bits: int = 3
    gripper_gravity: bool = True
    has_plate: bool = True
    ground: bool = True

    # reward
    reward_type: str = "insertion"  # insertion | pushing | sliding
    reward_weight: float = -0.8
    n_last_steps: int = 2
    weight_n_last_steps: float = 5.0
    orientation_weight: float = 0.5
    weight_orientation_n_last_steps: float = 5.0
    z_weight: float = 0.5
    ee_weight: float = -0.2  # pushing only
    velocity_weight: float = 0.0  # sliding: -0.1
    action_rate_weight: float = 0.0  # sliding: -2e-3

    # velocity-pass material; 0 runs no pass, dynamic_friction_scale=1.0 gives
    # each contact a dynamic coefficient equal to its static one
    restitution: float = 0.0
    dynamic_friction_scale: float = 0.0

    # reset randomisation; tuples are (lo, hi)
    object_xy_range: Tuple[float, float] = (-1.0, 1.0)
    object_z_range: Tuple[float, float] = (1.0, 1.5)  # absolute z after reset
    object_yaw_range: Tuple[float, float] = (-3.14159265, 3.14159265)
    target_z: float = 0.25
    target_yaw_range: Tuple[float, float] = (-3.14159265, 3.14159265)
    gripper_reset_with_object: bool = True
    # two-agent: rotate the object+gripper group around the target
    rotate_around_target: bool = False
    around_target_pitch_range: Tuple[float, float] = (-1.5707963, 0.0)

    @property
    def num_shapes(self) -> int:
        return len(self.shapes)

    @property
    def num_bodies(self) -> int:
        return self.num_grippers + 2 + (1 if self.has_plate else 0)

    @property
    def object_body(self) -> int:
        return self.num_grippers

    @property
    def target_body(self) -> int:
        return self.num_grippers + 1

    @property
    def plate_body(self) -> int:
        return self.num_grippers + 2

    @property
    def action_dim(self) -> int:
        return (3 if self.linear_only else 6) * self.num_grippers


class RigidEnvState(NamedTuple):
    scene: SceneState
    episode_step: torch.Tensor  # [B] int32
    generator: torch.Generator  # draws the fresh poses of done envs
    prev_action: torch.Tensor  # [B, A] (action-rate penalty)


def _axis_mask(bits: int):
    return [0.0 if bits & 1 else 1.0, 0.0 if bits & 2 else 1.0, 0.0 if bits & 4 else 1.0]


class RigidEnv:
    """Batched rigid-task environment on one device."""

    def __init__(self, cfg: RigidTaskCfg, device="cuda", rows: Optional[Rows] = None):
        """`rows` makes the env one process's row block of a data-parallel
        batch: `cfg.num_envs` of `rows.total` envs, drawing at the global
        width (`parallel.mesh`)."""
        self.cfg = cfg
        self.rows = rows
        self.device = device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("RigidEnv runs on the card by default and torch finds no CUDA device; "
                               "pass device='cpu' to run on the CPU")
        B = cfg.num_envs

        def t(values, dtype=torch.float32):
            return torch.tensor(values, dtype=dtype, device=device)

        self.shape_set: ShapeSet = build_shape_set(
            cfg.shapes, scale=cfg.shape_scale, half_height=cfg.shape_half_height, device=device
        )
        self.hole_set: ShapeSet = build_shape_set(
            cfg.shapes, scale=cfg.shape_scale, half_height=cfg.shape_half_height, clearance=cfg.hole_clearance,
            device=device,
        )
        # round-robin multi-asset assignment; per-env gathered geometry
        offset = 0 if rows is None else rows.index.start
        self.shape_ids = torch.arange(offset, offset + B, device=device) % cfg.num_shapes
        ss = self.shape_set
        self.obj_points = ss.points[self.shape_ids]  # [B, P, 3]
        self.obj_point_mask = ss.point_mask[self.shape_ids]
        self.obj_num_points = ss.num_points[self.shape_ids]
        self.obj_edges = ss.edges[self.shape_ids]
        self.obj_edge_mask = ss.edge_mask[self.shape_ids]
        self.obj_num_edges = ss.num_edges[self.shape_ids]
        self.obj_surface = ss.surface_points[self.shape_ids]
        self.hole_outline = self.hole_set.outline[self.shape_ids]  # [B, K, 2]
        self.obj_outline = ss.outline[self.shape_ids]
        self.infos = torch.cat(
            [self.obj_num_points[:, None].float(), self.obj_edges.reshape(B, -1).float(), self.obj_num_edges[:, None].float()],
            dim=-1,
        )

        self.body_spec = self._build_body_spec()
        self.anchors = [tuple(t(v) for v in self._gripper_anchor(i)) for i in range(cfg.num_grippers)]
        self.joints = self._build_joints() if cfg.attached else None
        self.obs_spec = self._build_obs_spec()

        # constants of the step, made once so the step copies nothing to the card
        self.identity_quat = t([1.0, 0.0, 0.0, 0.0]).expand(B, 4)
        self.push_offset = t([-0.4, 0.0, 0.0])
        self.rotation_mask = None
        if cfg.rotation_axis > -1:
            self.rotation_mask = torch.zeros(3, device=device)
            self.rotation_mask[cfg.rotation_axis] = 1.0
        sx, sy, sz = cfg.gripper_size
        self.stick_points = t([[x, y, z] for x in (-sx / 2, 0, sx / 2) for y in (-sy / 2, sy / 2) for z in (-sz / 2, 0, sz / 2)])
        self.fd_eps = 1e-4
        self.fd_x, self.fd_y = t([self.fd_eps, 0.0]), t([0.0, self.fd_eps])

    # ------------------------------------------------------------------ spec

    def _build_body_spec(self) -> RigidBodySpec:
        cfg = self.cfg
        dev = self.device
        inv_mass, inv_inertia, grav, lind, angd, fpos, frot = [], [], [], [], [], [], []
        for _ in range(cfg.num_grippers):
            inv_mass.append(1.0 / cfg.gripper_mass)
            inv_inertia.append(1.0 / box_inertia(cfg.gripper_mass, cfg.gripper_size, dev))
            grav.append(1.0 if cfg.gripper_gravity else 0.0)
            lind.append(cfg.gripper_damping)
            angd.append(cfg.gripper_damping)
            fpos.append([1.0, 1.0, 1.0])
            frot.append(_axis_mask(cfg.gripper_locked_rot_bits))
        size = (2 * cfg.shape_scale, 2 * cfg.shape_scale, 2 * cfg.shape_half_height)
        inv_mass.append(1.0 / cfg.object_mass)
        inv_inertia.append(1.0 / box_inertia(cfg.object_mass, size, dev))
        grav.append(1.0)
        lind.append(cfg.object_lin_damping)
        angd.append(cfg.object_ang_damping)
        fpos.append(_axis_mask(cfg.object_free_pos_bits))
        frot.append(_axis_mask(cfg.object_free_rot_bits))
        # target (+ plate): static
        for _ in range(1 + (1 if cfg.has_plate else 0)):
            inv_mass.append(0.0)
            inv_inertia.append(torch.zeros(3, device=dev))
            grav.append(0.0)
            lind.append(0.0)
            angd.append(0.0)
            fpos.append([0.0, 0.0, 0.0])
            frot.append([0.0, 0.0, 0.0])

        def t(values):
            return torch.tensor(values, dtype=torch.float32, device=dev)

        return RigidBodySpec(
            inv_mass=t(inv_mass), inv_inertia=torch.stack(inv_inertia), gravity_scale=t(grav),
            lin_damping=t(lind), ang_damping=t(angd), free_pos=t(fpos), free_rot=t(frot),
        )

    def _gripper_anchor(self, i: int):
        """(local on gripper, local on object) weld anchors. One gripper: the
        stick hangs above the peg, anchored at its lower end to the peg top.
        Two agents: the sticks attach to the peg's +/-y sides."""
        cfg = self.cfg
        if cfg.num_grippers == 1:
            return [0.0, 0.0, -0.5 * cfg.gripper_size[2]], [0.0, 0.0, cfg.shape_half_height]
        side = 1.0 if i == 0 else -1.0
        return [0.0, -side * 0.5 * cfg.gripper_size[1], 0.0], [0.0, side * cfg.shape_scale, 0.0]

    def _build_joints(self) -> FixedJointSpec:
        cfg = self.cfg
        G, dev = cfg.num_grippers, self.device
        joints = FixedJointSpec(
            body_a=torch.arange(G, device=dev),
            body_b=torch.full((G,), cfg.object_body, device=dev),
            local_pos_a=torch.stack([lp_g for lp_g, _ in self.anchors]),
            local_pos_b=torch.stack([lp_o for _, lp_o in self.anchors]),
            rel_quat=torch.tensor([[1.0, 0.0, 0.0, 0.0]] * G, device=dev),
        )
        return joint_sum_order(joints, self.body_spec.inv_mass.shape[0])

    def _build_obs_spec(self) -> ObsSpec:
        cfg = self.cfg
        P = self.obj_points.shape[1]
        E = self.obj_edges.shape[1]
        G = cfg.num_grippers
        names = {
            "scalars": ["object_target_distances"],
            "position_vectors": ["grippers", "object_geometry", "target_geometry"],
            "infos": ["object_num_points", "object_geometry_edges", "object_num_edges"],
        }
        dims = {
            "scalars": [P],
            "position_vectors": [3 * G, 3 * P, 3 * P],
            "infos": [1, 2 * E, 1],
        }
        if cfg.name == "rigid_insertion_two_agents":
            # velocities of the grippers only
            names["velocity_vectors"] = ["grippers"]
            dims["velocity_vectors"] = [3 * G]
        elif cfg.name == "rigid_sliding":
            # no object velocities
            names["velocity_vectors"] = ["grippers", "grippers_angular"]
            dims["velocity_vectors"] = [3 * G, 3 * G]
        else:
            names["velocity_vectors"] = ["grippers", "grippers_angular", "object_geometry", "object_geometry_angular"]
            dims["velocity_vectors"] = [3 * G, 3 * G, 3, 3]
        return ObsSpec(names=names, dims=dims)

    # ----------------------------------------------------------------- reset

    def _sample_poses(self, generator: torch.Generator):
        """Object/target poses, drawn from `generator` in a fixed order:
        object xy, object z, object yaw, target yaw (then the two-agent
        group's pitch and yaw)."""
        cfg = self.cfg
        B, dev = cfg.num_envs, self.device
        zeros = torch.zeros(B, device=dev)

        def uniform(lo, hi, shape):
            return draw_rows(lambda s: sample_uniform(generator, lo, hi, s, dev), shape, self.rows)

        obj_xy = uniform(*cfg.object_xy_range, (B, 2))
        obj_z = uniform(*cfg.object_z_range, (B, 1))
        obj_pos = torch.cat([obj_xy, obj_z], dim=-1)
        obj_quat = quat_from_euler_xyz(zeros, zeros, uniform(*cfg.object_yaw_range, (B,)))

        tgt_pos = torch.cat([torch.zeros((B, 2), device=dev), torch.full((B, 1), cfg.target_z, device=dev)], dim=-1)
        tgt_quat = quat_from_euler_xyz(zeros, zeros, uniform(*cfg.target_yaw_range, (B,)))

        if cfg.rotate_around_target:
            # two-agent: rotate the object+grippers group around the target
            # in the upper hemisphere
            pitch = uniform(*cfg.around_target_pitch_range, (B,))
            yaw = uniform(-math.pi, math.pi, (B,))
            rot = quat_mul(quat_from_euler_xyz(zeros, zeros, yaw), quat_from_euler_xyz(zeros, pitch, zeros))
            obj_pos = tgt_pos + quat_apply(rot, obj_pos - tgt_pos)
            obj_quat = quat_mul(rot, obj_quat)
        return obj_pos, obj_quat, tgt_pos, tgt_quat

    def _assemble_scene(self, obj_pos, obj_quat, tgt_pos, tgt_quat) -> SceneState:
        cfg = self.cfg
        pos, quat = [], []
        for lp_g, lp_o in self.anchors:
            if cfg.attached:
                # grippers at their weld pose relative to the object
                anchor_world = obj_pos + quat_apply(obj_quat, lp_o)
                pos.append(anchor_world - quat_apply(obj_quat, lp_g))
                quat.append(obj_quat)
            else:
                # pushing: the stick behind the object in the plane
                pos.append(obj_pos + self.push_offset)
                quat.append(self.identity_quat)
        pos += [obj_pos, tgt_pos] + ([tgt_pos] if cfg.has_plate else [])
        quat += [obj_quat, tgt_quat] + ([tgt_quat] if cfg.has_plate else [])
        pos = torch.stack(pos, dim=1)
        zeros = torch.zeros_like(pos)
        return SceneState(bodies=RigidBodyState(pos=pos, quat=torch.stack(quat, dim=1), lin_vel=zeros, ang_vel=zeros))

    def reset(self, generator: torch.Generator) -> RigidEnvState:
        cfg = self.cfg
        scene = self._assemble_scene(*self._sample_poses(generator))
        state = RigidEnvState(
            scene=scene,
            episode_step=torch.zeros((cfg.num_envs,), dtype=torch.int32, device=self.device),
            generator=generator,
            prev_action=torch.zeros((cfg.num_envs, cfg.action_dim), device=self.device),
        )
        for _ in range(cfg.warmup_steps):
            state = state._replace(scene=self._physics(state.scene, zero_vel=True))
        return state

    # ------------------------------------------------------------------ step

    def _contacts(self, scene: SceneState):
        """This step's contact sets; the SDFs close over the per-env geometry
        and the current poses of the static bodies."""
        cfg = self.cfg
        contacts, pair_contacts = [], []

        def material(friction):
            return dict(friction=friction, restitution=cfg.restitution,
                        dynamic_friction=cfg.dynamic_friction_scale * friction)

        if cfg.ground:
            contacts.append(ContactSet(body=cfg.object_body, local_points=self.obj_surface, sdf=ground_sdf, **material(0.5)))
        if cfg.has_plate:
            plate_pos = scene.bodies.pos[:, cfg.plate_body]
            plate_quat = scene.bodies.quat[:, cfg.plate_body]
            half = cfg.plate_half_thickness

            def plate_sdf(world_pts):
                local = quat_apply(quat_conjugate(plate_quat)[:, None, :], world_pts - plate_pos[:, None, :])
                phi, n_local = hole_plate_sdf(local, self.hole_outline, cfg.plate_half_extent, half, -half)
                return phi, quat_apply(plate_quat[:, None, :], n_local)

            contacts.append(ContactSet(body=cfg.object_body, local_points=self.obj_surface, sdf=plate_sdf, **material(0.3)))
        if not cfg.attached:
            # pushing: gripper stick vs object prism (both ways via pair contact)
            outline, hh, eps = self.obj_outline, cfg.shape_half_height, self.fd_eps

            def obj_sdf(local_pts):
                # prism SDF in the object's local frame; in-plane normal from
                # central differences of the polygon SDF, z from the slab
                q = local_pts[..., :2]
                poly = polygon_sdf_2d(q, outline)
                dz = torch.abs(local_pts[..., 2]) - hh
                phi = torch.maximum(poly, dz)
                gx = polygon_sdf_2d(q + self.fd_x, outline) - polygon_sdf_2d(q - self.fd_x, outline)
                gy = polygon_sdf_2d(q + self.fd_y, outline) - polygon_sdf_2d(q - self.fd_y, outline)
                in_plane = poly > dz
                n = torch.stack(
                    [
                        torch.where(in_plane, gx / (2 * eps), 0.0),
                        torch.where(in_plane, gy / (2 * eps), 0.0),
                        torch.where(in_plane, 0.0, torch.sign(local_pts[..., 2])),
                    ],
                    dim=-1,
                )
                return phi, n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-9)

            for i in range(cfg.num_grippers):
                pair_contacts.append(BodyPairContact(
                    body_points=i, body_sdf=cfg.object_body, local_points=self.stick_points, sdf=obj_sdf, **material(0.6),
                ))
        return contacts, pair_contacts

    def _physics(self, scene: SceneState, zero_vel: bool = False) -> SceneState:
        cfg = self.cfg
        if zero_vel:
            zeros = torch.zeros_like(scene.bodies.lin_vel)
            scene = scene._replace(bodies=scene.bodies._replace(lin_vel=zeros, ang_vel=zeros))
        contacts, pair_contacts = self._contacts(scene)
        return step_physics(
            scene, self.body_spec, cfg.dt, cfg.decimation, joints=self.joints, contacts=contacts,
            pair_contacts=pair_contacts, iterations=cfg.iterations,
        )

    def _apply_action(self, scene: SceneState, action: torch.Tensor) -> SceneState:
        """Clamp, then write each gripper's root velocity: the linear part as
        is, the angular part as omega = (r x v_tangential) / |r|^2 * scale
        around the gripper's position r."""
        cfg = self.cfg
        a = torch.clamp(action, -cfg.action_max, cfg.action_max)
        per = 3 if cfg.linear_only else 6
        lin, ang = {}, {}
        for i in range(cfg.num_grippers):
            ai = a[:, i * per : (i + 1) * per]
            v = ai[:, :3] * cfg.action_linear_scale
            if not cfg.z_action:
                v = torch.cat([v[:, :2], torch.zeros_like(v[:, 2:])], dim=-1)
            lin[i] = v
            if cfg.linear_only:
                ang[i] = torch.zeros_like(v)
                continue
            r = scene.bodies.pos[:, i]
            vr = ai[:, 3:]
            r2 = torch.clamp((r * r).sum(dim=-1, keepdim=True), min=1e-9)
            v_par = ((vr * r).sum(dim=-1, keepdim=True) / r2) * r
            omega = torch.linalg.cross(r, vr - v_par, dim=-1) / r2 * cfg.action_angular_scale
            ang[i] = omega * self.rotation_mask if self.rotation_mask is not None else omega
        bodies = scene.bodies._replace(lin_vel=with_bodies(scene.bodies.lin_vel, lin),
                                       ang_vel=with_bodies(scene.bodies.ang_vel, ang))
        return scene._replace(bodies=bodies)

    # ------------------------------------------------------------- obs/reward

    def _observe(self, state: RigidEnvState) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        B, G = cfg.num_envs, cfg.num_grippers
        bodies = state.scene.bodies
        obj_pts = transform_points(self.obj_points, bodies.pos[:, cfg.object_body], bodies.quat[:, cfg.object_body])
        tgt_pts = transform_points(self.obj_points, bodies.pos[:, cfg.target_body], bodies.quat[:, cfg.target_body])

        grip_vel = bodies.lin_vel[:, :G].reshape(B, -1)
        grip_ang = bodies.ang_vel[:, :G].reshape(B, -1)
        if cfg.name == "rigid_insertion_two_agents":
            velocity_vectors = grip_vel
        elif cfg.name == "rigid_sliding":
            velocity_vectors = torch.cat([grip_vel, grip_ang], dim=-1)
        else:
            velocity_vectors = torch.cat(
                [grip_vel, grip_ang, bodies.lin_vel[:, cfg.object_body], bodies.ang_vel[:, cfg.object_body]], dim=-1
            )
        return {
            "scalars": torch.linalg.vector_norm(obj_pts - tgt_pts, dim=-1),  # [B, P]
            "position_vectors": torch.cat([bodies.pos[:, :G].reshape(B, -1), obj_pts.reshape(B, -1), tgt_pts.reshape(B, -1)], dim=-1),
            "velocity_vectors": velocity_vectors,
            "infos": self.infos,
        }

    def _reward(self, state: RigidEnvState, action: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        bodies = state.scene.bodies
        obj_pos = bodies.pos[:, cfg.object_body]
        dvec = obj_pos - bodies.pos[:, cfg.target_body]
        distance = torch.linalg.vector_norm(dvec, dim=-1)
        ori_dist = quat_error_magnitude(bodies.quat[:, cfg.object_body], bodies.quat[:, cfg.target_body])

        in_last = state.episode_step >= cfg.episode_length - cfg.n_last_steps
        w_last = torch.where(in_last, cfg.weight_n_last_steps, 1.0)
        w_ori_last = torch.where(in_last, cfg.weight_orientation_n_last_steps, 1.0)

        if cfg.reward_type == "insertion":
            z_dist = torch.abs(dvec[:, 2])
            r = w_last * distance + cfg.orientation_weight * (w_ori_last * ori_dist) + cfg.z_weight * z_dist
            return cfg.reward_weight * r
        if cfg.reward_type == "pushing":
            r = w_last * distance + cfg.orientation_weight * (w_last * ori_dist)
            ee = torch.linalg.vector_norm(obj_pos - bodies.pos[:, 0], dim=-1)
            return cfg.reward_weight * r + cfg.ee_weight * ee
        if cfg.reward_type == "sliding":
            r = w_last * distance + cfg.orientation_weight * (w_last * ori_dist)
            vel = torch.linalg.vector_norm(bodies.lin_vel[:, cfg.object_body], dim=-1) + torch.linalg.vector_norm(
                bodies.ang_vel[:, cfg.object_body], dim=-1
            )
            act_rate = ((action - state.prev_action) ** 2).sum(dim=-1)
            return cfg.reward_weight * r + cfg.velocity_weight * vel + cfg.action_rate_weight * act_rate
        raise ValueError(cfg.reward_type)

    # -------------------------------------------------------------- full step

    def step(self, state: RigidEnvState, action: torch.Tensor) -> Tuple[RigidEnvState, TimeStep]:
        cfg = self.cfg
        scene = self._physics(self._apply_action(state.scene, action))
        stepped = state._replace(scene=scene, episode_step=state.episode_step + 1)

        reward = self._reward(stepped, action)
        done = stepped.episode_step >= cfg.episode_length

        # done envs restart from fresh poses, drawn for every env on every
        # step (no warmup on auto-reset, as in the reference)
        fresh = self._assemble_scene(*self._sample_poses(state.generator))
        d3 = done[:, None, None]
        new_state = RigidEnvState(
            scene=SceneState(bodies=RigidBodyState(*(torch.where(d3, f, s) for f, s in zip(fresh.bodies, scene.bodies)))),
            episode_step=torch.where(done, 0, stepped.episode_step).to(torch.int32),
            generator=state.generator,
            prev_action=torch.where(done[:, None], 0.0, action),
        )
        obs = self._observe(new_state)
        # pre-reset object -> target distance: the task-success diagnostic
        dist = torch.linalg.vector_norm(scene.bodies.pos[:, cfg.object_body] - scene.bodies.pos[:, cfg.target_body], dim=-1)
        info = {"episode_step": new_state.episode_step, "object_target_distance": dist}
        return new_state, TimeStep(obs=obs, reward=reward, done=done, info=info)

    def observe(self, state: RigidEnvState) -> Dict[str, torch.Tensor]:
        return self._observe(state)


# ---------------------------------------------------------------------------
# task registrations
# ---------------------------------------------------------------------------


def rigid_insertion_cfg(num_envs: int = 40, **kw) -> RigidTaskCfg:
    return RigidTaskCfg(name="rigid_insertion", num_envs=num_envs, **kw)


def rigid_insertion_two_agents_cfg(num_envs: int = 40, **kw) -> RigidTaskCfg:
    kw.setdefault("num_grippers", 2)
    kw.setdefault("linear_only", True)
    kw.setdefault("z_action", True)
    kw.setdefault("object_free_rot_bits", 3)
    kw.setdefault("gripper_locked_rot_bits", 7)
    kw.setdefault("gripper_gravity", False)
    kw.setdefault("gripper_size", (0.025, 0.15, 0.025))
    kw.setdefault("reward_type", "insertion")
    kw.setdefault("orientation_weight", 0.1)
    kw.setdefault("weight_orientation_n_last_steps", 7.5)
    kw.setdefault("z_weight", 0.0)
    kw.setdefault("object_xy_range", (0.25, 0.75))
    kw.setdefault("object_z_range", (0.5, 1.25))
    kw.setdefault("rotate_around_target", True)
    return RigidTaskCfg(name="rigid_insertion_two_agents", num_envs=num_envs, **kw)


def rigid_pushing_cfg(num_envs: int = 40, **kw) -> RigidTaskCfg:
    kw.setdefault("shapes", PUSHING_SHAPE_NAMES)
    kw.setdefault("attached", False)
    kw.setdefault("linear_only", True)
    kw.setdefault("z_action", False)
    kw.setdefault("object_mass", 3.0)
    kw.setdefault("object_ang_damping", 10.0)
    kw.setdefault("object_free_pos_bits", 4)
    kw.setdefault("object_free_rot_bits", 3)
    kw.setdefault("gripper_locked_rot_bits", 7)
    kw.setdefault("gripper_gravity", False)
    kw.setdefault("gripper_size", (0.5, 0.05, 0.05))
    kw.setdefault("has_plate", False)
    kw.setdefault("reward_type", "pushing")
    kw.setdefault("n_last_steps", 5)
    kw.setdefault("weight_n_last_steps", 10.0)
    kw.setdefault("orientation_weight", 0.1)
    kw.setdefault("object_xy_range", (-0.5, 0.5))
    kw.setdefault("object_z_range", (0.06, 0.06))
    kw.setdefault("target_z", 0.06)
    kw.setdefault("warmup_steps", 5)
    return RigidTaskCfg(name="rigid_pushing", num_envs=num_envs, **kw)


def rigid_sliding_cfg(num_envs: int = 40, **kw) -> RigidTaskCfg:
    kw.setdefault("shapes", ("L",))
    kw.setdefault("attached", True)
    kw.setdefault("linear_only", False)
    kw.setdefault("z_action", False)
    kw.setdefault("rotation_axis", 2)
    kw.setdefault("object_mass", 1.0)
    kw.setdefault("object_ang_damping", 10.0)
    kw.setdefault("object_free_pos_bits", 4)
    kw.setdefault("object_free_rot_bits", 3)
    kw.setdefault("has_plate", False)
    kw.setdefault("reward_type", "sliding")
    kw.setdefault("n_last_steps", 2)
    kw.setdefault("weight_n_last_steps", 5.0)
    kw.setdefault("orientation_weight", 0.5)
    kw.setdefault("velocity_weight", -0.1)
    kw.setdefault("action_rate_weight", -2e-3)
    kw.setdefault("object_xy_range", (-1.0, 1.0))
    kw.setdefault("object_z_range", (0.06, 0.06))
    kw.setdefault("target_z", 0.06)
    kw.setdefault("warmup_steps", 5)
    return RigidTaskCfg(name="rigid_sliding", num_envs=num_envs, **kw)


TASK_REGISTRY = {
    "rigid_insertion": rigid_insertion_cfg,
    "rigid_insertion_two_agents": rigid_insertion_two_agents_cfg,
    "rigid_pushing": rigid_pushing_cfg,
    "rigid_sliding": rigid_sliding_cfg,
}
