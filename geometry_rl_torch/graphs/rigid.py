"""Rigid-task graph builder: observation groups -> HeteroGraph + features
(port of `geometry_rl_tpu/graphs/rigid.py`), plus the observation splitting
and training-noise augmentation that the other builders share.

The kNN graph of a rigid body's mesh points is invariant under rigid
motion, so the internal topology is computed once per shape with numpy and
gathered per env (`env_ids` gathers each sample's topology in a shuffled
minibatch).

Node types: object_geometry (padded mesh points), grippers. Edge types:
  (object_geometry, internal, object_geometry): kNN (k = 3) over mesh points,
  (grippers, agent, grippers): fully connected (G > 1),
  (object_geometry, task, grippers): every valid point -> every gripper.
Features: scalars = one-hot over 3 node classes (the target class is
excluded from the graph but keeps its slot); vectors = [norm_pos,
corresponding_pos, velocity, angular_velocity], the object's root
velocities broadcast to its points.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..envs.base import ObsSpec
from ..parallel.mesh import RowGenerator, draw_rows
from .homogenize import merged_csr
from .types import EdgeSet, GraphFeatures, HeteroGraph, NodeSet, csr_from_index

NODE_TYPES = ("object_geometry", "grippers", "target_geometry")  # one-hot order


def knn_edges(points: np.ndarray, num_valid: int, k: int) -> np.ndarray:
    """Directed kNN edges (j -> i for j among i's k nearest, self excluded),
    node by node: [num_valid * min(k, num_valid - 1), 2] (src, dst).
    Neighbours are ranked by f32 squared distance, and a tie goes to the
    lower index (a stable sort), the order of the JAX package's native C++
    kNN (`native.knn_graph_batch`)."""
    if num_valid <= 1 or k <= 0:
        return np.zeros((0, 2), np.int64)
    pts = np.asarray(points[:num_valid], np.float32)
    d = pts[None, :, :] - pts[:, None, :]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]  # f32, the C++ sum order
    np.fill_diagonal(d2, np.inf)
    kk = min(k, num_valid - 1)
    nbrs = np.argsort(d2, axis=-1, kind="stable")[:, :kk]
    dst = np.repeat(np.arange(num_valid), kk)
    return np.stack([nbrs.reshape(-1), dst], axis=-1)


def knn_graph_batch(points: np.ndarray, num_valid: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Padded topology of S shapes: points [S, P, 3], counts [S] ->
    (src [S, P*k], dst [S, P*k], mask [S, P*k])."""
    S, P = points.shape[:2]
    src = np.zeros((S, P * k), np.int32)
    dst = np.zeros((S, P * k), np.int32)
    mask = np.zeros((S, P * k), np.float32)
    for s in range(S):
        e = knn_edges(points[s], int(num_valid[s]), k)
        src[s, : len(e)], dst[s, : len(e)], mask[s, : len(e)] = e[:, 0], e[:, 1], 1.0
    return src, dst, mask


def apply_training_noise(vectors: Dict[str, torch.Tensor], generator: torch.Generator, std: float) -> Dict[str, torch.Tensor]:
    """Gaussian data-augmentation noise on the per-node vector features,
    drawn from `generator` node type by node type: applied only on training
    forwards, drawn fresh per network update."""
    return {nt: v + noise_like(v, generator, std) for nt, v in vectors.items()}


def noise_like(x: torch.Tensor, generator, std: float) -> torch.Tensor:
    """std * N(0, 1) noise of x's shape from `generator`; from a
    `RowGenerator`, this process's rows of a draw over the global minibatch."""
    if isinstance(generator, RowGenerator):
        return std * draw_rows(lambda s: torch.randn(s, generator=generator.generator, dtype=x.dtype, device=x.device),
                               x.shape, generator.rows)
    return std * torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)


def split_group(obs: torch.Tensor, spec: ObsSpec, group: str) -> Dict[str, torch.Tensor]:
    """Split a flat group tensor into named terms."""
    out = {}
    start = 0
    for name, dim in zip(spec.names[group], spec.dims[group]):
        out[name] = obs[..., start : start + dim]
        start += dim
    return out


class RigidGraphBuilder:
    """Static per-env graph topology + feature construction."""

    num_scalar_features = len(NODE_TYPES)
    num_vector_features = 4

    def __init__(
        self,
        obs_spec: ObsSpec,
        num_grippers: int,
        num_points: int,  # P_max
        dist_as_pos: bool,
        angular_velocity: bool,
        internal_src: torch.Tensor,  # [B_env, E] per-env static topology
        internal_dst: torch.Tensor,
        internal_mask: torch.Tensor,
        point_mask: torch.Tensor,  # [B_env, P]
        output_mask_key: str = "grippers",
        training_noise: bool = False,
        training_noise_std: float = 1e-2,
    ):
        self.obs_spec = obs_spec
        self.num_grippers, self.num_points = num_grippers, num_points
        self.dist_as_pos, self.angular_velocity = dist_as_pos, angular_velocity
        self.internal_src, self.internal_dst, self.internal_mask = internal_src, internal_dst, internal_mask
        self.point_mask = point_mask
        self.output_mask_key = output_mask_key
        self.training_noise, self.training_noise_std = training_noise, training_noise_std
        G, P, dev = num_grippers, num_points, point_mask.device
        self.graph_levels = ("internal", "agent", "task") if G > 1 else ("internal", "task")  # its graphs' edge levels
        pairs = [(i, j) for i in range(G) for j in range(G) if i != j]
        self._agent = (torch.tensor([p[0] for p in pairs], device=dev), torch.tensor([p[1] for p in pairs], device=dev))
        self._task = (torch.arange(P, device=dev).repeat(G), torch.arange(G, device=dev).repeat_interleave(P))
        # the CSRs of every src and dst index, the order of the models' sums: the
        # kNN topology's per env (each env's shape), the others' shared
        self._internal_csr = (csr_from_index(internal_src, P), csr_from_index(internal_dst, P))
        self._agent_csr = (csr_from_index(self._agent[0], G), csr_from_index(self._agent[1], G))
        self._task_csr = (csr_from_index(self._task[0], P), csr_from_index(self._task[1], G))
        topology = {("object_geometry", "internal", "object_geometry"): (internal_src, internal_dst)}
        if G > 1:
            topology[("grippers", "agent", "grippers")] = self._agent
        topology[("object_geometry", "task", "grippers")] = self._task
        self._merged_csr = merged_csr({"object_geometry": P, "grippers": G}, topology)  # build()'s graph order
        self._one_hot = {nt: torch.eye(len(NODE_TYPES), device=dev)[i] for i, nt in enumerate(NODE_TYPES)}

    @staticmethod
    def from_env(env, dist_as_pos: bool = True, angular_velocity: bool = True, knn_k: int = 3,
                 training_noise: bool = False, training_noise_std: float = 1e-2) -> "RigidGraphBuilder":
        """Per-shape kNN topology, gathered per env."""
        ss = env.shape_set
        src, dst, mask = knn_graph_batch(ss.points.cpu().numpy(), ss.num_points.cpu().numpy(), knn_k)
        ids = env.shape_ids.cpu().numpy()
        dev = env.device
        return RigidGraphBuilder(
            obs_spec=env.obs_spec,
            num_grippers=env.cfg.num_grippers,
            num_points=ss.points.shape[1],
            dist_as_pos=dist_as_pos,
            angular_velocity=angular_velocity and "object_geometry_angular" in env.obs_spec.names["velocity_vectors"],
            internal_src=torch.as_tensor(src[ids], dtype=torch.int64, device=dev),
            internal_dst=torch.as_tensor(dst[ids], dtype=torch.int64, device=dev),
            internal_mask=torch.as_tensor(mask[ids], device=dev),
            point_mask=env.obj_point_mask,
            training_noise=training_noise,
            training_noise_std=training_noise_std,
        )

    def build(
        self,
        tobs: Dict[str, torch.Tensor],
        env_ids: Optional[torch.Tensor] = None,
        noise_generator: Optional[torch.Generator] = None,
    ) -> Tuple[HeteroGraph, GraphFeatures]:
        """The graph and features of `tobs` (the obs pipeline's output: raw
        `position_vectors` and the normalised groups, each [N, D]);
        `env_ids` [N] maps each sample to its env's topology (default: the
        collection layout, sample i = env i), and `noise_generator` draws the
        training noise when the builder has it on."""
        spec = self.obs_spec
        B = tobs["position_vectors"].shape[0]
        G, P = self.num_grippers, self.num_points

        i_src_csr, i_dst_csr = self._internal_csr
        if env_ids is None:
            i_src, i_dst, i_mask, p_mask = self.internal_src, self.internal_dst, self.internal_mask, self.point_mask
            merged = lambda: self._merged_csr  # noqa: E731
        else:
            i_src, i_dst = self.internal_src[env_ids], self.internal_dst[env_ids]
            i_mask, p_mask = self.internal_mask[env_ids], self.point_mask[env_ids]
            i_src_csr, i_dst_csr = i_src_csr.select(env_ids), i_dst_csr.select(env_ids)
            merged = lambda: tuple(csr.select(env_ids) for csr in self._merged_csr)  # noqa: E731  (on demand)

        pos = split_group(tobs["position_vectors"], spec, "position_vectors")
        npos = split_group(tobs["norm_position_vectors"], spec, "position_vectors")
        nvel = split_group(tobs["norm_velocity_vectors"], spec, "velocity_vectors")

        grip_npos = npos["grippers"].reshape(B, G, 3)
        obj_npos = npos["object_geometry"].reshape(B, P, 3)
        tgt_npos = npos["target_geometry"].reshape(B, P, 3)
        nodes = {
            "object_geometry": NodeSet(pos=pos["object_geometry"].reshape(B, P, 3), norm_pos=obj_npos, mask=p_mask),
            "grippers": NodeSet(pos=pos["grippers"].reshape(B, G, 3), norm_pos=grip_npos),
        }
        edges = {("object_geometry", "internal", "object_geometry"): EdgeSet(
            src=i_src, dst=i_dst, mask=i_mask, dst_csr=i_dst_csr, src_csr=i_src_csr)}
        if G > 1:
            a_src, a_dst = self._agent
            edges[("grippers", "agent", "grippers")] = EdgeSet(
                src=a_src.expand(B, -1), dst=a_dst.expand(B, -1), mask=torch.ones((B, a_src.shape[0]), device=p_mask.device),
                dst_csr=self._agent_csr[1], src_csr=self._agent_csr[0],
            )
        t_src, t_dst = self._task
        edges[("object_geometry", "task", "grippers")] = EdgeSet(src=t_src.expand(B, -1), dst=t_dst.expand(B, -1),
                                                                 mask=p_mask.repeat(1, G), dst_csr=self._task_csr[1],
                                                                 src_csr=self._task_csr[0])
        graph = HeteroGraph(nodes=nodes, edges=edges, output_node_type=self.output_mask_key, merged_csr=merged)

        # features
        one_hot = {"object_geometry": self._one_hot["object_geometry"].expand(B, P, 3),
                   "grippers": self._one_hot["grippers"].expand(B, G, 3)}
        corr_obj = obj_npos - tgt_npos if self.dist_as_pos else tgt_npos

        zeros_obj = torch.zeros_like(obj_npos)
        if "object_geometry" in spec.names["velocity_vectors"]:
            v_obj = nvel["object_geometry"].reshape(B, 1, 3).expand(B, P, 3)
            w_obj = nvel["object_geometry_angular"].reshape(B, 1, 3).expand(B, P, 3) if self.angular_velocity else zeros_obj
        else:
            v_obj = w_obj = zeros_obj
        zeros_grip = torch.zeros_like(grip_npos)
        v_grip = nvel["grippers"].reshape(B, G, 3)
        if "grippers_angular" in spec.names["velocity_vectors"] and self.angular_velocity:
            w_grip = nvel["grippers_angular"].reshape(B, G, 3)
        else:
            w_grip = zeros_grip

        vectors = {
            "object_geometry": torch.stack([obj_npos, corr_obj, v_obj, w_obj], dim=2),  # [B, P, 4, 3]
            "grippers": torch.stack([grip_npos, zeros_grip, v_grip, w_grip], dim=2),
        }
        if self.training_noise and noise_generator is not None:
            vectors = apply_training_noise(vectors, noise_generator, self.training_noise_std)
        return graph, GraphFeatures(scalars=one_hot, vectors=vectors)
