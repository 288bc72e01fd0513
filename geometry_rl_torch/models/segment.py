"""Fixed-order segment sum: CUDA kernel and its plain PyTorch version.

The graph models' message sums (`models/common.py`: `scatter_sum` and the
backward of `gather_nodes`) add the rows of `values` [B, E, F] into N
segments per env, in the order a `CSR` fixes (`graphs/types.py`): segment m
of env b sums rows perm[b, offsets[b, m]:offsets[b, m + 1]] one after the
other, in f32, and rounds once to the values' type. The JAX package computes
these sums as one-hot contractions (`geometry_rl_tpu/models/common.py`),
which XLA evaluates in a fixed order; PyTorch's `index_add_` sums with float
atomics on the card, in an order that changes from run to run. Following a
CSR, made once where a topology is made, a run gives the same bits every
time, without PyTorch's deterministic mode.

`segment_sum` launches `csrc/segment_sum.cu` for CUDA tensors (no fallback:
the kernel or an exception) and runs the plain version `segment_sum_ref` for
CPU tensors; both add in the same order, so they agree bit for bit. A CSR
that a caller does not have is made on the spot by `csr_from_index` (a
stable sort, deterministic too); `ON_THE_SPOT` (`graphs/types.py`) counts those.
"""

from __future__ import annotations

import ctypes
import torch

from ..graphs.types import CSR, ON_THE_SPOT, csr_or_on_the_spot  # noqa: F401

# kernel launches since the last reset, counted where the kernel launches
LAUNCHES = {"segment_sum": 0}

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the C entry `segment_sum_launch`: 4 pointers, 7 ints, the stream
KERNEL_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


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


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shapes, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) not in shapes:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected one of {shapes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _kernel_fn():
    """The ctypes entry `segment_sum_launch` of `csrc/segment_sum.cu`, built at first use."""
    from ..cuda_build import load_library

    fn = load_library("segment_sum").segment_sum_launch
    if fn.argtypes is None:
        fn.argtypes, fn.restype = KERNEL_ARGTYPES, ctypes.c_int
    return fn


def segment_sum_cuda(values: torch.Tensor, csr: CSR) -> torch.Tensor:
    """Launch `csrc/segment_sum.cu` on the current stream: values [B, E, F]
    (f32 or bf16, contiguous, on the card) -> [B, N, F]. Raises on operands
    the kernel does not take; never reads the card from the host."""
    dev = values.device
    if dev.type != "cuda":
        raise ValueError(f"segment_sum needs CUDA tensors, got {dev}")
    if values.dtype not in KERNEL_DTYPES:
        raise TypeError(f"segment_sum takes f32 or bf16 values, got {values.dtype}")
    if values.ndim != 3 or not values.is_contiguous():
        raise ValueError(f"values must be a contiguous [B, E, F] tensor, got {tuple(values.shape)}")
    B, E, F = values.shape
    n = csr.num_segments
    Bp = csr.perm.shape[0]
    _check("csr.perm", csr.perm, torch.int32, {(1, E), (B, E)}, dev)
    _check("csr.offsets", csr.offsets, torch.int32, {(Bp, n + 1)}, dev)
    out = torch.empty((B, n, F), dtype=values.dtype, device=dev)
    stride = 0 if Bp == 1 else 1
    fn = _kernel_fn()
    with torch.cuda.device(dev):
        err = fn(values.data_ptr(), csr.perm.data_ptr(), csr.offsets.data_ptr(), out.data_ptr(),
                 KERNEL_DTYPES[values.dtype], B, E, n, F, stride * E, stride * (n + 1),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: CUDA error {err}")
    LAUNCHES["segment_sum"] += 1
    return out


def segment_sum(values: torch.Tensor, csr: CSR) -> torch.Tensor:
    """values [B, E, F] summed into [B, N, F] in `csr`'s order: the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if values.device.type == "cpu":
        return segment_sum_ref(values, csr)
    return segment_sum_cuda(values.contiguous(), csr)
