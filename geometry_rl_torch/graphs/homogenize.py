"""Hetero -> homogeneous graph merging (port of
`geometry_rl_tpu/graphs/homogenize.py`) for the EMPN / GCN / MeshGraphNet /
Transformer baselines and the DeepSets critic. Node types are concatenated in
`graph.nodes` order; edge indices are offset into the merged node array.
With `with_csr`, the merged edge set carries the CSRs of its src and dst, the
order of the message-passing baselines' sums: the graph's `merged_csr`, which
its builder made once with `merged_csr` below (a graph without them gets them
on the spot, counted in `ON_THE_SPOT`)."""

from __future__ import annotations

from itertools import accumulate
from typing import Dict, NamedTuple, Tuple

import torch

from .types import CSR, EdgeKey, EdgeSet, GraphFeatures, HeteroGraph, csr_from_index, csr_or_on_the_spot


class HomogeneousGraph(NamedTuple):
    pos: torch.Tensor  # [B, Ntot, 3]
    node_mask: torch.Tensor  # [B, Ntot]
    edges: EdgeSet  # merged, with offset indices
    edge_type_onehot: torch.Tensor  # [B, Etot, num_edge_types]
    node_slices: Dict[str, Tuple[int, int]]  # node type -> (start, stop)

    def output_slice(self, graph: HeteroGraph) -> Tuple[int, int]:
        return self.node_slices[graph.output_node_type]


def homogenize(graph: HeteroGraph, with_csr: bool = False) -> HomogeneousGraph:
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
    if with_csr:
        src_csr, dst_csr = graph.merged_csr() if graph.merged_csr is not None else (None, None)
        edges = edges._replace(src_csr=csr_or_on_the_spot(src_csr, src, offset),
                               dst_csr=csr_or_on_the_spot(dst_csr, dst, offset))
    return HomogeneousGraph(pos, node_mask, edges, torch.cat(onehot_list, dim=1), slices)


def merged_csr(num_nodes: Dict[str, int], edges: Dict[EdgeKey, Tuple[torch.Tensor, torch.Tensor]]) -> Tuple[CSR, CSR]:
    """The CSRs (src, dst) of a topology's merged edge set, for a builder to
    make once: `num_nodes` and `edges` ((src, dst) per edge key) in the
    order of the graphs it builds. An index [E] serves every env, [B, E] is
    each env's own; with any of the latter, the CSRs are each env's."""
    starts = dict(zip(num_nodes, accumulate(num_nodes.values(), initial=0)))
    B = max((s.shape[0] for s, _ in edges.values() if s.ndim == 2), default=1)

    def merged(side: int) -> torch.Tensor:
        parts = [pair[side] + starts[key[2 * side]] for key, pair in edges.items()]
        return torch.cat([p.expand(B, -1) if p.ndim == 1 else p for p in parts], dim=1)

    n = sum(num_nodes.values())
    return csr_from_index(merged(0), n), csr_from_index(merged(1), n)


def concat_features(graph: HeteroGraph, feats: GraphFeatures) -> torch.Tensor:
    """Merged flat node features [B, Ntot, F] in node-type order."""
    flat = feats.concat()
    return torch.cat([flat[nt] for nt in graph.nodes.keys()], dim=1)
