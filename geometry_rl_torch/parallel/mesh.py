"""Env-axis data parallelism on `torch.distributed` (port of
`geometry_rl_tpu/parallel/mesh.py`).

The env axis is the data-parallel axis: of W processes, rank r steps envs
[r*B/W, (r+1)*B/W) of the global B. Parameters, optimiser states, the
normaliser and the generators are replicated. Every rank builds the full
initial state identically from the seed and keeps its row block
(`shard_train_state`); a generator is never split: every rank holds the same
one and advances it identically, drawing at the global width and keeping its
rows (`Rows`, `draw_rows`). Where XLA inserts the reductions over a sharded
axis implicitly, the port writes them out: the trainer all-reduces the
normaliser's sums, the gradients and the metrics, and inside a minibatch
(`global_batch`) the losses take their means as a local sum over the global
count (`batch_mean`) and their normalisations from global reductions
(`batch_global_mean`, `batch_total`).
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Union

import torch
import torch.distributed as dist

class Rows(NamedTuple):
    """This process's rows of a draw made at the global width."""

    index: Union[slice, torch.Tensor]
    total: int


class RowGenerator(NamedTuple):
    """A generator whose draws are made at `rows.total` and cut to `rows`."""

    generator: torch.Generator
    rows: Rows


def draw_rows(draw: Callable[[tuple], torch.Tensor], shape: Sequence[int], rows: Optional[Rows]) -> torch.Tensor:
    """`draw(shape)`; with `rows`, drawn at the global width along the first
    axis and cut to this process's rows, so every process advances its
    generator as one process drawing all rows would."""
    if rows is None:
        return draw(tuple(shape))
    return draw((rows.total,) + tuple(shape[1:]))[rows.index]


def env_rows(num_envs: int, rank: int, world: int) -> Rows:
    """Rank `rank`'s row block of `num_envs` envs over `world` processes."""
    if num_envs % world:
        raise ValueError(f"env axis {num_envs} not divisible by process count {world}")
    per = num_envs // world
    return Rows(slice(rank * per, (rank + 1) * per), num_envs)


class DataParallel:
    """The collectives of one data-parallel run over the default process
    group. With gloo, CUDA tensors travel through host copies (gloo's CUDA
    support covers only some collectives); NCCL takes them as they are."""

    def __init__(self):
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.backend = dist.get_backend()

    def rows(self, num_envs: int) -> Rows:
        return env_rows(num_envs, self.rank, self.world)

    def _run(self, x: torch.Tensor, collective) -> torch.Tensor:
        staged = x.cpu() if self.backend == "gloo" and x.is_cuda else x.contiguous()
        out = collective(staged)
        return out.to(x.device) if out.device != x.device else out

    def all_reduce(self, tensors: List[torch.Tensor], op: str = "sum") -> List[torch.Tensor]:
        """Each tensor reduced over the ranks (sum, max or min), in one
        collective per dtype group of the list."""
        if not tensors:
            return []
        flat = torch.cat([t.detach().reshape(-1).to(torch.float64 if t.dtype == torch.float64 else torch.float32)
                          for t in tensors])
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}[op]

        def run(x):
            dist.all_reduce(x, op=red)
            return x

        flat = self._run(flat, run)
        out, start = [], 0
        for t in tensors:
            out.append(flat[start : start + t.numel()].reshape(t.shape).to(t.dtype))
            start += t.numel()
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' tensors of one shape concatenated along the first axis."""

        def run(x):
            out = torch.empty((self.world * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
            dist.all_gather_into_tensor(out, x)
            return out

        if self.backend == "gloo":  # gloo has no all_gather_into_tensor
            def run(x):  # noqa: F811
                parts = [torch.empty_like(x) for _ in range(self.world)]
                dist.all_gather(parts, x)
                return torch.cat(parts)

        return self._run(x, run)

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        def run(x):
            x = x.clone()
            dist.broadcast(x, src)
            return x

        return self._run(x, run)

    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        box = [obj]
        dist.broadcast_object_list(box, src=src, device=None if self.backend == "gloo" else torch.device("cuda", torch.cuda.current_device()))
        return box[0]


class _AllReduceSum(torch.autograd.Function):
    """A sum over the ranks whose gradient is the sum over the ranks of the
    incoming gradients: every rank's loss depends on the global value."""

    @staticmethod
    def forward(ctx, x, dp):
        ctx.dp = dp
        return dp.all_reduce([x])[0]

    @staticmethod
    def backward(ctx, grad):
        return ctx.dp.all_reduce([grad])[0], None


_BATCH: Optional[tuple] = None  # (DataParallel, global sample count) inside `global_batch`


@contextlib.contextmanager
def global_batch(dp: Optional[DataParallel], n: int):
    """Within the block, the `batch_*` reductions treat each process's
    samples as its share of a global batch of `n` samples."""
    global _BATCH
    prev, _BATCH = _BATCH, (None if dp is None else (dp, n))
    try:
        yield
    finally:
        _BATCH = prev


def _per_sample(x: torch.Tensor) -> int:
    return math.prod(x.shape[1:])


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """`x.mean()`; inside a data-parallel `global_batch`, this process's
    share of the global mean (its sum over the global count): a loss term
    whose gradient the all-reduced gradients complete, or a metric the
    trainer sums over the ranks."""
    if _BATCH is None:
        return x.mean()
    return x.sum() / (_BATCH[1] * _per_sample(x))


def batch_global_mean(x: torch.Tensor) -> torch.Tensor:
    """`x.mean()` over the global batch on every process, differentiable:
    for means that enter per-sample values (normalisations, PAPI's expected
    divergences)."""
    if _BATCH is None:
        return x.mean()
    dp, n = _BATCH
    return _AllReduceSum.apply(x.sum(), dp) / (n * _per_sample(x))


def batch_total(share: torch.Tensor) -> torch.Tensor:
    """A detached quantity summed over the processes (a global mean from the
    `batch_mean` shares); itself outside data parallelism."""
    if _BATCH is None:
        return share.detach()
    return _BATCH[0].all_reduce([share.detach()])[0]


def batch_std(x: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    """`x.std(correction=0)` over the global batch, given its global mean."""
    if _BATCH is None:
        return x.std(correction=0)
    return torch.sqrt(batch_global_mean((x - mean) ** 2))


def batch_logsumexp(x: torch.Tensor) -> torch.Tensor:
    """`torch.logsumexp(x, 0)` over the global batch (detached inside a
    data-parallel batch)."""
    if _BATCH is None:
        return torch.logsumexp(x, 0)
    dp = _BATCH[0]
    x = x.detach()
    m = dp.all_reduce([x.max() if x.numel() else x.new_full((), -math.inf)], "max")[0]
    return m + torch.log(dp.all_reduce([torch.exp(x - m).sum()])[0])


def batch_size(x: torch.Tensor) -> int:
    """The (global) number of samples of the batch `x` belongs to."""
    return x.shape[0] if _BATCH is None else _BATCH[1]


# ---------------------------------------------------------------------------
# placement of states
# ---------------------------------------------------------------------------


def _map_tree(fn, tree):
    """`fn` on every tensor of a NamedTuple / tuple / list / dict tree;
    generators and other leaves pass through."""
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_tree(fn, t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tree(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return tree


def shard_env_state(tree, rows: Rows, num_envs: int):
    """Every [num_envs, ...] tensor of `tree` (an env state or observation)
    cut to `rows`; everything else, a generator above all, replicated."""
    return _map_tree(lambda x: x[rows.index] if x.ndim >= 1 and x.shape[0] == num_envs else x, tree)


def gather_env_state(tree, dp: DataParallel, local_envs: int):
    """The inverse of `shard_env_state`: every [local_envs, ...] tensor
    gathered over the ranks into the global [world * local_envs, ...] in rank
    order (a collective: every rank calls it)."""
    return _map_tree(lambda x: dp.all_gather(x) if x.ndim >= 1 and x.shape[0] == local_envs else x, tree)


def shard_train_state(state, rows: Rows, num_envs: int):
    """A TrainState of the global batch with its env state and observation
    cut to `rows`; parameters (in the trainer's modules), optimiser states,
    the normaliser, the generator and the counters stay replicated."""
    return state._replace(env_state=shard_env_state(state.env_state, rows, num_envs),
                          obs=shard_env_state(state.obs, rows, num_envs))


def replicate(module: torch.nn.Module, dp: DataParallel) -> torch.nn.Module:
    """Rank 0's parameters and buffers copied into `module` on every rank."""
    with torch.no_grad():
        for t in module.state_dict().values():
            t.copy_(dp.broadcast(t))
    return module
