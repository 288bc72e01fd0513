"""Rope-task graph builder (port of `geometry_rl_tpu/graphs/rope.py`).

Node types, all three kept: links, grippers and target_geometry (isolated
nodes without an edge, yet encoded by HEPi and pooled by the DeepSets
critic). Edge types: links kNN "internal" (computed once from the straight
rest layout, the same for every env), gripper-gripper "agent" pairs, and
links -> grippers fully connected "task" edges. Features: one-hot over the 3
node classes + 3 vectors [norm_pos, corresponding_pos, velocity].
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..envs.base import ObsSpec
from .rigid import apply_training_noise, split_group
from .types import EdgeSet, GraphFeatures, HeteroGraph, NodeSet

NODE_TYPES = ("links", "grippers", "target_geometry")  # one-hot order


def knn_edges_np(points: np.ndarray, num_valid: int, k: int) -> np.ndarray:
    """Directed kNN edges (j -> i for j among i's k nearest): [num_valid * k,
    2] (src, dst). This is the reference's numpy kNN kept operation for
    operation (norms in the points' own precision, `np.argsort` with its
    default kind), because on the rope's straight rest layout the 3rd and 4th
    nearest links are often exactly as far, and there the sort decides which
    one the graph gets. `graphs/rigid.knn_edges` (f32 squared distances,
    stable sort) picks other neighbours on those rows."""
    pts = points[:num_valid]
    d = np.linalg.norm(pts[:, None] - pts[None, :], axis=-1)
    np.fill_diagonal(d, np.inf)
    nbrs = np.argsort(d, axis=-1)[:, :k]  # [n, k]
    dst = np.repeat(np.arange(num_valid), k)
    return np.stack([nbrs.reshape(-1), dst], axis=-1)


class RopeGraphBuilder:
    num_scalar_features = len(NODE_TYPES)
    num_vector_features = 3
    graph_levels = ("internal", "agent", "task")  # the edge levels of its graphs

    def __init__(
        self,
        obs_spec: ObsSpec,
        num_links: int,
        num_grippers: int,
        dist_as_pos: bool,
        internal_src: torch.Tensor,  # [E] static chain topology, the same for all envs
        internal_dst: torch.Tensor,
        output_mask_key: str = "grippers",
        training_noise: bool = False,
        training_noise_std: float = 1e-2,
    ):
        self.obs_spec = obs_spec
        self.num_links, self.num_grippers = num_links, num_grippers
        self.dist_as_pos = dist_as_pos
        self.internal_src, self.internal_dst = internal_src, internal_dst
        self.output_mask_key = output_mask_key
        self.training_noise, self.training_noise_std = training_noise, training_noise_std
        L, G, dev = num_links, num_grippers, internal_src.device
        pairs = [(i, j) for i in range(G) for j in range(G) if i != j]
        self._edges = {
            ("links", "internal", "links"): (internal_src, internal_dst),
            ("grippers", "agent", "grippers"): (torch.tensor([p[0] for p in pairs], device=dev),
                                                torch.tensor([p[1] for p in pairs], device=dev)),
            ("links", "task", "grippers"): (torch.arange(L, device=dev).repeat(G),
                                            torch.arange(G, device=dev).repeat_interleave(L)),
        }
        self._one_hot = {nt: torch.eye(len(NODE_TYPES), device=dev)[i] for i, nt in enumerate(NODE_TYPES)}

    @staticmethod
    def from_env(env, dist_as_pos: bool = True, knn_k: int = 3, training_noise: bool = False,
                 training_noise_std: float = 1e-2) -> "RopeGraphBuilder":
        cfg = env.cfg
        L = cfg.num_links
        x = np.arange(L, dtype=np.float32) * cfg.link_spacing
        e = knn_edges_np(np.stack([x, np.zeros(L), np.zeros(L)], axis=-1), L, knn_k)
        return RopeGraphBuilder(
            obs_spec=env.obs_spec,
            num_links=L,
            num_grippers=cfg.num_grippers,
            dist_as_pos=dist_as_pos,
            internal_src=torch.as_tensor(e[:, 0], dtype=torch.int64, device=env.device),
            internal_dst=torch.as_tensor(e[:, 1], dtype=torch.int64, device=env.device),
            training_noise=training_noise,
            training_noise_std=training_noise_std,
        )

    def build(
        self,
        tobs: Dict[str, torch.Tensor],
        env_ids: Optional[torch.Tensor] = None,
        noise_generator: Optional[torch.Generator] = None,
    ) -> Tuple[HeteroGraph, GraphFeatures]:
        """The graph and features of `tobs`. Every env has the same topology,
        so `env_ids` changes nothing; `noise_generator` draws the training
        noise when the builder has it on."""
        spec = self.obs_spec
        B = tobs["position_vectors"].shape[0]
        L, G = self.num_links, self.num_grippers

        pos = split_group(tobs["position_vectors"], spec, "position_vectors")
        npos = split_group(tobs["norm_position_vectors"], spec, "position_vectors")
        nvel = split_group(tobs["norm_velocity_vectors"], spec, "velocity_vectors")

        grip_npos = npos["grippers"].reshape(B, G, 3)
        link_npos = npos["links"].reshape(B, L, 3)
        tgt_npos = npos["target_geometry"].reshape(B, L, 3)
        nodes = {
            "links": NodeSet(pos=pos["links"].reshape(B, L, 3), norm_pos=link_npos),
            "grippers": NodeSet(pos=pos["grippers"].reshape(B, G, 3), norm_pos=grip_npos),
            "target_geometry": NodeSet(pos=pos["target_geometry"].reshape(B, L, 3), norm_pos=tgt_npos),
        }
        edges = {
            ek: EdgeSet(src=src.expand(B, -1), dst=dst.expand(B, -1),
                        mask=torch.ones((B, src.shape[0]), dtype=grip_npos.dtype, device=grip_npos.device))
            for ek, (src, dst) in self._edges.items()
        }
        graph = HeteroGraph(nodes=nodes, edges=edges, output_node_type=self.output_mask_key)

        one_hot = {nt: self._one_hot[nt].expand(B, ns.num_nodes, len(NODE_TYPES)) for nt, ns in nodes.items()}
        corr_links = link_npos - tgt_npos if self.dist_as_pos else tgt_npos
        zeros_grip, zeros_tgt = torch.zeros_like(grip_npos), torch.zeros_like(tgt_npos)
        vectors = {
            "links": torch.stack([link_npos, corr_links, nvel["links"].reshape(B, L, 3)], dim=2),
            "grippers": torch.stack([grip_npos, zeros_grip, nvel["grippers"].reshape(B, G, 3)], dim=2),
            "target_geometry": torch.stack([tgt_npos, zeros_tgt, zeros_tgt], dim=2),
        }
        if self.training_noise and noise_generator is not None:
            vectors = apply_training_noise(vectors, noise_generator, self.training_noise_std)
        return graph, GraphFeatures(scalars=one_hot, vectors=vectors)
