"""Cloth-task graph builder (port of `geometry_rl_tpu/graphs/cloth.py`).

The POLICY graph holds 4 grippers + 10 hole-boundary nodes; the CRITIC graph
(full_graph_obs=True) also keeps the 225 particles. Edges: hole-boundary
fully connected ("internal"), gripper-gripper ("agent"), hole-boundary ->
gripper ("task"), all static. Features: one-hot over the 4 node classes + 3
vectors [norm_pos, corresponding_pos, velocity].
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..envs.base import ObsSpec
from .rigid import apply_training_noise, split_group
from .types import EdgeSet, GraphFeatures, HeteroGraph, NodeSet, csr_from_index

ONE_HOT = {
    "particles": (1.0, 0.0, 0.0, 0.0),
    "grippers": (0.0, 1.0, 0.0, 0.0),
    "hole_boundary": (0.0, 0.0, 1.0, 0.0),
    "target_hook": (0.0, 0.0, 0.0, 1.0),
}


def _full_pairs(n: int, m: int, exclude_diag: bool, device) -> Tuple[torch.Tensor, torch.Tensor]:
    pairs = [(a, b) for a in range(n) for b in range(m) if not (exclude_diag and a == b)]
    src, dst = zip(*pairs)
    return torch.tensor(src, device=device), torch.tensor(dst, device=device)


class ClothGraphBuilder:
    num_scalar_features = len(ONE_HOT["grippers"])
    num_vector_features = 3
    graph_levels = ("internal", "agent", "task")  # the edge levels of its graphs

    def __init__(
        self,
        obs_spec: ObsSpec,
        num_grippers: int,
        num_particles: int,
        num_boundary: int,
        full_graph_obs: bool,
        dist_as_pos: bool,
        hole_mask: torch.Tensor,  # [B_env, P] 1 = removed particle
        output_mask_key: str = "grippers",
        training_noise: bool = False,
        training_noise_std: float = 1e-2,
    ):
        self.obs_spec = obs_spec
        self.num_grippers, self.num_particles, self.num_boundary = num_grippers, num_particles, num_boundary
        self.full_graph_obs = full_graph_obs
        self.dist_as_pos = dist_as_pos
        self.output_mask_key = output_mask_key
        self.hole_mask = hole_mask
        self.training_noise, self.training_noise_std = training_noise, training_noise_std
        dev = hole_mask.device
        K, G = num_boundary, num_grippers
        self._edges = {
            ("hole_boundary", "internal", "hole_boundary"): _full_pairs(K, K, True, dev),
            ("grippers", "agent", "grippers"): _full_pairs(G, G, True, dev),
            ("hole_boundary", "task", "grippers"): _full_pairs(K, G, False, dev),
        }
        # the CSRs of the static src and dst indices: the order of the models' sums
        sizes = {"hole_boundary": K, "grippers": G}
        self._csr = {(s_t, level, d_t): (csr_from_index(src, sizes[s_t]), csr_from_index(dst, sizes[d_t]))
                     for (s_t, level, d_t), (src, dst) in self._edges.items()}
        self._one_hot = {nt: torch.tensor(v, device=dev) for nt, v in ONE_HOT.items()}

    @staticmethod
    def from_env(env, dist_as_pos: bool = False, full_graph_obs: bool = False, training_noise: bool = False,
                 training_noise_std: float = 1e-2) -> "ClothGraphBuilder":
        from ..envs.cloth import K_BOUNDARY, N_PARTICLES

        return ClothGraphBuilder(
            obs_spec=env.obs_spec,
            num_grippers=env.cfg.num_grippers,
            num_particles=N_PARTICLES,
            num_boundary=K_BOUNDARY,
            full_graph_obs=full_graph_obs,
            dist_as_pos=dist_as_pos,
            hole_mask=env.hole_mask,
            training_noise=training_noise,
            training_noise_std=training_noise_std,
        )

    def build(
        self,
        tobs: Dict[str, torch.Tensor],
        env_ids: Optional[torch.Tensor] = None,
        noise_generator: Optional[torch.Generator] = None,
    ) -> Tuple[HeteroGraph, GraphFeatures]:
        """The graph and features of `tobs`; `env_ids` picks each sample's
        env (hole mask) in a shuffled minibatch, and `noise_generator` draws
        the training noise when the builder has it on."""
        spec = self.obs_spec
        B = tobs["position_vectors"].shape[0]
        G, P, K = self.num_grippers, self.num_particles, self.num_boundary
        hole_mask = self.hole_mask if env_ids is None else self.hole_mask[env_ids]

        pos = split_group(tobs["position_vectors"], spec, "position_vectors")
        npos = split_group(tobs["norm_position_vectors"], spec, "position_vectors")
        nvel = split_group(tobs["norm_velocity_vectors"], spec, "velocity_vectors")

        grip_npos = npos["grippers"].reshape(B, G, 3)
        bnd_npos = npos["hole_boundary"].reshape(B, K, 3)
        hook_npos = npos["target_hook"].reshape(B, 1, 3)

        nodes = {
            "grippers": NodeSet(pos=pos["grippers"].reshape(B, G, 3), norm_pos=grip_npos),
            "hole_boundary": NodeSet(pos=pos["hole_boundary"].reshape(B, K, 3), norm_pos=bnd_npos),
        }
        corr_bnd = bnd_npos - hook_npos if self.dist_as_pos else hook_npos.expand(B, K, 3)
        vectors = {
            "grippers": torch.stack([grip_npos, torch.zeros_like(grip_npos), nvel["grippers"].reshape(B, G, 3)], dim=2),
            # hole_boundary has no velocity term in the obs groups
            "hole_boundary": torch.stack([bnd_npos, corr_bnd, torch.zeros_like(bnd_npos)], dim=2),
        }
        if self.full_graph_obs:
            part_npos = npos["particles"].reshape(B, P, 3)
            init_npos = npos["init_particles"].reshape(B, P, 3)
            nodes["particles"] = NodeSet(pos=pos["particles"].reshape(B, P, 3), norm_pos=part_npos, mask=1.0 - hole_mask)
            corr_p = part_npos - init_npos if self.dist_as_pos else init_npos
            vectors["particles"] = torch.stack([part_npos, corr_p, nvel["particles"].reshape(B, P, 3)], dim=2)
        one_hot = {nt: self._one_hot[nt].expand(B, ns.num_nodes, 4) for nt, ns in nodes.items()}

        edges = {}
        for ek, (src, dst) in self._edges.items():
            src_csr, dst_csr = self._csr[ek]
            edges[ek] = EdgeSet(
                src=src.expand(B, -1), dst=dst.expand(B, -1),
                mask=torch.ones((B, src.shape[0]), dtype=grip_npos.dtype, device=grip_npos.device),
                dst_csr=dst_csr, src_csr=src_csr,
            )
        graph = HeteroGraph(nodes=nodes, edges=edges, output_node_type=self.output_mask_key)
        if self.training_noise and noise_generator is not None:
            vectors = apply_training_noise(vectors, noise_generator, self.training_noise_std)
        return graph, GraphFeatures(scalars=one_hot, vectors=vectors)
