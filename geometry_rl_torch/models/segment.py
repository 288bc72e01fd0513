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
one of the kernel's two routes or an exception) and runs the plain version
`segment_sum_ref` for CPU tensors; both add in the same order, so they agree
bit for bit. `launch_plan`, pure Python, picks the route (16 bytes a thread
through TMA bulk copies where the row and the pointers allow it, scalar loads
elsewhere), the segment groups and column tile each CTA owns, the grid, the
ring and the shared memory. A CSR that a caller does not have is made on the
spot by `csr_from_index` (a stable sort, deterministic too); `ON_THE_SPOT`
(`graphs/types.py`) counts those.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple

import torch

from ..graphs.types import CSR, ON_THE_SPOT, csr_or_on_the_spot  # noqa: F401
from ..utils.trace import count, spanned

# the kernel's routes, by the number the C entry takes; each launch counts
# `kernels.segment_sum` and `kernels.segment_sum.<route>`
ROUTES = ("vec16", "scalar")

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the C entry `segment_sum_launch`: 4 pointers, 14 ints, the stream
KERNEL_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 14 + [ctypes.c_void_p]

H100_SMS = 132  # streaming multiprocessors of an H100 SXM
SMEM_LIMIT = 232448  # dynamic shared memory a block may ask for on Hopper (227 KB)
CTAS_PER_SM = 4  # the vec16 route splits envs until the grid has this many CTAs per SM
MIN_GROUP_ROWS = 8  # ... first into segment groups of about this many rows or more,
MAX_TILE_BYTES = 4096  # ... then into column tiles: the widest 8 consumer warps of 16 bytes a thread,
MIN_TILE_BYTES = 512  # the narrowest one warp
STAGES = 4  # the vec16 route's ring: STAGES stages of whole rows of the tile, ...
RING_BYTES = 16384  # ... RING_BYTES in all
SCALAR_TILE = 256  # the scalar route's columns per CTA: one a thread


class LaunchPlan(NamedTuple):
    route: str  # "vec16" or "scalar"
    tile: int  # columns per CTA
    groups: int  # CTAs per env and tile, each summing a run of whole segments (1 on the scalar route)
    grid: int  # CTAs: B x groups x column tiles
    threads: int  # per CTA: the tile's consumer warps and the producer warp (vec16), or a thread per column (scalar)
    stages: int  # the vec16 route's ring in shared memory: stages (0 on the scalar route) ...
    stage_rows: int  # ... of this many row slices each, one wait and one release a stage (0 on the scalar route)
    smem: int  # dynamic shared memory bytes: mbarriers, ring, the env's offsets and perm
    smem_limit: int  # what a block may ask for; smem stays within it


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=1024)
def launch_plan(B: int, E: int, N: int, F: int, dtype: torch.dtype, aligned: bool, sms: int = H100_SMS) -> LaunchPlan:
    """How `csrc/segment_sum.cu` runs values [B, E, F] of `dtype` into N
    segments. `aligned`: the values' and the output's data pointers are
    16-byte aligned. The vec16 route takes rows of a multiple of 16 bytes from
    aligned pointers. A CTA's stream of rows is serial, so where the envs do
    not fill the card (CTAS_PER_SM per SM) it splits each env into segment
    groups (down to about MIN_GROUP_ROWS rows), then into narrower column tiles
    (down to MIN_TILE_BYTES); its ring holds RING_BYTES in STAGES stages (at
    least one row a stage; fewer rows, then down to 2 stages, where the env's
    indices take the room). Every other case takes the scalar route. Raises
    where the env's indices do not fit in shared memory."""
    elt = torch.empty((), dtype=dtype).element_size()
    index_bytes = 4 * (E + N + 1)
    row = F * elt
    if aligned and row % 16 == 0:
        tiles, groups = max(1, _cdiv(row, MAX_TILE_BYTES)), 1
        while B * groups * tiles < CTAS_PER_SM * sms and E // (2 * groups) >= MIN_GROUP_ROWS:
            groups *= 2
        while B * groups * tiles < CTAS_PER_SM * sms and _cdiv(row, 2 * tiles) >= MIN_TILE_BYTES:
            tiles *= 2
        tile_bytes = max(16, _cdiv(_cdiv(row, tiles), 16) * 16)
        stages, stage_rows = STAGES, max(1, RING_BYTES // tile_bytes // STAGES)

        def smem(stages, stage_rows):  # the stages' full and empty mbarriers, the ring, the indices
            return _cdiv(16 * stages, 128) * 128 + stages * stage_rows * tile_bytes + index_bytes

        while stage_rows > 1 and smem(stages, stage_rows) > SMEM_LIMIT:  # where the indices take the room
            stage_rows -= 1
        while stages > 2 and smem(stages, stage_rows) > SMEM_LIMIT:
            stages -= 1
        tile = tile_bytes // elt
        plan = LaunchPlan("vec16", tile, groups, B * groups * _cdiv(F, tile), 32 * (_cdiv(tile_bytes // 16, 32) + 1),
                          stages, stage_rows, smem(stages, stage_rows), SMEM_LIMIT)
    else:
        tile = max(1, min(F, SCALAR_TILE))
        plan = LaunchPlan("scalar", tile, 1, B * _cdiv(F, tile), 32 * _cdiv(tile, 32), 0, 0, index_bytes, SMEM_LIMIT)
    if plan.smem > plan.smem_limit:
        raise ValueError(f"segment_sum: the {E} rows and {N} segments of an env need {plan.smem} bytes of shared "
                         f"memory, more than the {plan.smem_limit} a block may have")
    return plan


_SMS: Dict[int, int] = {}


def _sms(dev: torch.device) -> int:
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SMS[index]


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


def segment_sum_cuda(values: torch.Tensor, csr: CSR, plan: LaunchPlan | None = None) -> torch.Tensor:
    """Launch `csrc/segment_sum.cu` on the current stream: values [B, E, F]
    (f32 or bf16, contiguous, on the card) -> [B, N, F], by `plan` (default:
    `launch_plan`'s; the C entry refuses one it cannot run). Raises on
    operands the kernel does not take; never reads the card from the host."""
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
    if plan is None:
        aligned = values.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
        plan = launch_plan(B, E, n, F, values.dtype, aligned, _sms(dev))
    stride = 0 if Bp == 1 else 1
    fn = _kernel_fn()
    with torch.cuda.device(dev):
        err = fn(values.data_ptr(), csr.perm.data_ptr(), csr.offsets.data_ptr(), out.data_ptr(),
                 KERNEL_DTYPES[values.dtype], B, E, n, F, stride * E, stride * (n + 1), ROUTES.index(plan.route),
                 plan.tile, plan.groups, plan.stages, plan.stage_rows, plan.threads, plan.smem,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"segment_sum kernel launch failed ({plan.route} route): CUDA error {err}")
    count("kernels.segment_sum")
    count(f"kernels.segment_sum.{plan.route}")
    return out


@spanned("kernels.segment_sum")
def segment_sum(values: torch.Tensor, csr: CSR) -> torch.Tensor:
    """values [B, E, F] summed into [B, N, F] in `csr`'s order: the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if values.device.type == "cpu":
        return segment_sum_ref(values, csr)
    return segment_sum_cuda(values.contiguous(), csr)
