"""Padded heterogeneous graph batch (port of `geometry_rl_tpu/graphs/types.py`).

Node sets are [B, N_t, ...] per node type; edge sets are [B, E] index pairs
local to their endpoint node types with a float mask. Edge keys are
(src_type, level, dst_type) triples; HEPi schedules messages by level.
An edge set may carry the CSR of its `dst` and `src` indices (`CSR`), made
where its topology is made: the fixed order in which the message sums of
`models/common.py` add its edges up.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

EdgeKey = Tuple[str, str, str]  # (src_type, level, dst_type)


class NodeSet(NamedTuple):
    pos: torch.Tensor  # [B, N, 3] raw world positions
    norm_pos: torch.Tensor  # [B, N, 3] normalized positions
    mask: Optional[torch.Tensor] = None  # [B, N] 1.0 = real node (None = all real)

    @property
    def num_nodes(self) -> int:
        return self.pos.shape[-2]


class CSR(NamedTuple):
    """The fixed summation order of an index [B, E] into n segments (nodes):
    `perm` holds each env's edges stably sorted by their index, and segment m
    sums edges perm[offsets[m]:offsets[m + 1]] in that order. A leading axis
    of 1 serves every env (a topology all envs share)."""

    perm: torch.Tensor  # [1 or B, E] int32 edge numbers
    offsets: torch.Tensor  # [1 or B, n + 1] int32

    @property
    def num_segments(self) -> int:
        return self.offsets.shape[-1] - 1

    def select(self, env_ids: torch.Tensor) -> "CSR":
        """The CSR of the envs `env_ids` (a shared one serves them all)."""
        if self.perm.shape[0] == 1:
            return self
        return CSR(self.perm[env_ids], self.offsets[env_ids])


def csr_from_index(idx: torch.Tensor, n: int) -> CSR:
    """The CSR of an index [B, E] (or [E], one topology) into n segments:
    each env's edges stably sorted by their index. Indices outside [0, n)
    fall in no segment."""
    if idx.ndim == 1:
        idx = idx[None]
    sorted_idx, perm = torch.sort(idx, dim=-1, stable=True)
    bounds = torch.arange(n + 1, dtype=sorted_idx.dtype, device=idx.device).expand(idx.shape[0], n + 1)
    offsets = torch.searchsorted(sorted_idx.contiguous(), bounds.contiguous(), out_int32=True)
    return CSR(perm.to(torch.int32), offsets)


# CSRs made inside a sum or a merge because the caller passed none (no main path does)
ON_THE_SPOT = {"csr": 0}


def csr_or_on_the_spot(csr: Optional[CSR], idx: torch.Tensor, n: int) -> CSR:
    """`csr`, or the CSR of idx into n segments made now (and counted)."""
    if csr is not None:
        return csr
    ON_THE_SPOT["csr"] += 1
    return csr_from_index(idx, n)


class EdgeSet(NamedTuple):
    src: torch.Tensor  # [B, E] int64 into src node type
    dst: torch.Tensor  # [B, E] int64 into dst node type
    mask: torch.Tensor  # [B, E] float 1.0 = real edge
    dst_csr: Optional[CSR] = None  # the order of the sums into dst nodes (a scatter)
    src_csr: Optional[CSR] = None  # into src nodes (a gather's backward)

    @property
    def num_edges(self) -> int:
        return self.src.shape[-1]


class HeteroGraph(NamedTuple):
    nodes: Dict[str, NodeSet]
    edges: Dict[EdgeKey, EdgeSet]
    output_node_type: str  # node type read out by the policy

    @property
    def node_types(self):
        return list(self.nodes.keys())

    @property
    def edge_types(self):
        return list(self.edges.keys())


class GraphFeatures(NamedTuple):
    """Per-node-type input features: scalars = one-hot node type [B, N_t, S];
    vectors = stacked geometric 3-vectors [B, N_t, V, 3]."""

    scalars: Dict[str, torch.Tensor]
    vectors: Dict[str, torch.Tensor]

    def concat(self) -> Dict[str, torch.Tensor]:
        """Flat per-node feature: [B, N_t, S + 3V]."""
        return {
            nt: torch.cat([s, self.vectors[nt].reshape(self.vectors[nt].shape[:-2] + (-1,))], dim=-1)
            for nt, s in self.scalars.items()
        }
