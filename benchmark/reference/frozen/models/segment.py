"""Fixed-order segment sum, the plain version alone (frozen copy).

`segment_sum_ref` adds the rows of `values` [B, E, F] into N segments per
env in the order a `CSR` fixes, in f32, rounded once to the values' type:
the sums the port's CUDA kernel computes bit for bit.
"""

from __future__ import annotations

import torch

from ..graphs.types import CSR, ON_THE_SPOT, csr_or_on_the_spot  # noqa: F401

def _accumulator(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype


def segment_sum_ref(values: torch.Tensor, csr: CSR) -> torch.Tensor:
    """The plain version: values [B, E, F] -> [B, N, F], each segment summed
    row by row in `csr.perm` order in f32 (f64 stays f64), rounded once to the
    values' type. One gather and one add per rank within a segment, up to the
    longest segment; ranks past a segment's end read an appended zero row."""
    B, E, F = values.shape
    n = csr.num_segments
    perm, offsets = csr.perm.long(), csr.offsets.long()
    counts = offsets[:, 1:] - offsets[:, :-1]  # [Bp, N]
    depth = int(counts.max()) if counts.numel() else 0
    acc = torch.zeros((B * n, F), dtype=_accumulator(values.dtype), device=values.device)
    if depth == 0:
        return acc.reshape(B, n, F).to(values.dtype)
    rank = torch.arange(depth, device=values.device)
    pos = torch.clamp(offsets[:, :-1, None] + rank, max=E - 1)  # [Bp, N, D] places in perm
    rows = torch.where(rank < counts[..., None], perm.gather(1, pos.reshape(perm.shape[0], -1)).reshape(pos.shape), E)
    rows = (rows.expand(B, n, depth) + (E + 1) * torch.arange(B, device=values.device)[:, None, None]).reshape(B * n, depth)
    ext = torch.cat([values.to(acc.dtype), torch.zeros((B, 1, F), dtype=acc.dtype, device=values.device)], 1)
    ext = ext.reshape(B * (E + 1), F)
    for d in range(depth):
        acc = acc + ext.index_select(0, rows[:, d])
    return acc.reshape(B, n, F).to(values.dtype)


def segment_sum(values: torch.Tensor, csr: CSR) -> torch.Tensor:
    """values [B, E, F] summed into [B, N, F] in `csr`'s order, by the plain
    version on every device."""
    return segment_sum_ref(values, csr)
