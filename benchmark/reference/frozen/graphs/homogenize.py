"""Hetero -> homogeneous graph merging for the DeepSets critic. Node types
are concatenated in `graph.nodes` order; edge indices are offset into the
merged node array."""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from .types import EdgeSet, GraphFeatures, HeteroGraph


class HomogeneousGraph(NamedTuple):
    pos: torch.Tensor  # [B, Ntot, 3]
    node_mask: torch.Tensor  # [B, Ntot]
    edges: EdgeSet  # merged, with offset indices
    edge_type_onehot: torch.Tensor  # [B, Etot, num_edge_types]
    node_slices: Dict[str, Tuple[int, int]]  # node type -> (start, stop)

    def output_slice(self, graph: HeteroGraph) -> Tuple[int, int]:
        return self.node_slices[graph.output_node_type]


def homogenize(graph: HeteroGraph) -> HomogeneousGraph:
    offsets: Dict[str, int] = {}
    slices: Dict[str, Tuple[int, int]] = {}
    pos_list, mask_list = [], []
    offset = 0
    for nt, ns in graph.nodes.items():
        offsets[nt] = offset
        slices[nt] = (offset, offset + ns.num_nodes)
        pos_list.append(ns.pos)
        mask_list.append(torch.ones(ns.pos.shape[:2], dtype=ns.pos.dtype, device=ns.pos.device) if ns.mask is None else ns.mask)
        offset += ns.num_nodes
    pos = torch.cat(pos_list, dim=1)
    node_mask = torch.cat(mask_list, dim=1)

    num_et = len(graph.edges)
    src_list, dst_list, emask_list, onehot_list = [], [], [], []
    for ei, (ek, es) in enumerate(graph.edges.items()):
        s_t, _, d_t = ek
        src_list.append(es.src + offsets[s_t])
        dst_list.append(es.dst + offsets[d_t])
        emask_list.append(es.mask)
        oh = torch.zeros(es.src.shape + (num_et,), dtype=pos.dtype, device=pos.device)
        oh.select(-1, ei).fill_(1.0)  # `oh[..., ei] = 1.0` would copy a host scalar to the card
        onehot_list.append(oh)
    src, dst = torch.cat(src_list, dim=1), torch.cat(dst_list, dim=1)
    edges = EdgeSet(src=src, dst=dst, mask=torch.cat(emask_list, dim=1))
    return HomogeneousGraph(pos, node_mask, edges, torch.cat(onehot_list, dim=1), slices)


def concat_features(graph: HeteroGraph, feats: GraphFeatures) -> torch.Tensor:
    """Merged flat node features [B, Ntot, F] in node-type order."""
    flat = feats.concat()
    return torch.cat([flat[nt] for nt in graph.nodes.keys()], dim=1)
