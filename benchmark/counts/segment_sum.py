"""Bytes of one fixed-order segment sum: the values, the CSR's perm and
offsets read once, the output written once (the count behind
`segment_sum_roofline.*`; one f32 add per value is far below the card's
f32 rate, so bytes bound it)."""

from __future__ import annotations

INDEX_BYTES = 4  # perm and offsets are int32


def segment_sum_bytes(values_shape, element_size: int, perm_numel: int, offsets_numel: int, num_segments: int) -> int:
    """values [B, E, F] of `element_size` bytes into [B, num_segments, F]."""
    B, E, F = values_shape
    return B * E * F * element_size + INDEX_BYTES * (perm_numel + offsets_numel) + B * num_segments * F * element_size
