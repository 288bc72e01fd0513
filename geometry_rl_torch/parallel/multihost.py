"""Multi-process initialisation (port of `geometry_rl_tpu/parallel/multihost.py`).

One training run can span several processes, one card each, that together
form one data-parallel program over the env axis (`parallel/mesh.py`).
`torch.distributed` wires them together; the launch modes are the JAX
package's:
- explicit: GEOMRL_COORDINATOR=host:port, GEOMRL_NUM_PROCESSES and
  GEOMRL_PROCESS_ID (a `tcp://` rendezvous);
- GEOMRL_MULTIHOST=1: torchrun's `RANK`, `WORLD_SIZE`, `MASTER_ADDR` and
  `MASTER_PORT` (an `env://` rendezvous).
The backend is NCCL for CUDA devices and gloo for the CPU unless the caller
names one.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def maybe_initialize_distributed(device="cuda", backend: Optional[str] = None) -> bool:
    """Join the process group when this is one process of a multi-process
    launch; returns False (and does nothing) for a single-process run."""
    coord = os.environ.get("GEOMRL_COORDINATOR")
    if not coord and os.environ.get("GEOMRL_MULTIHOST") != "1":
        return False
    if dist.is_initialized():
        return True
    backend = backend or ("nccl" if torch.device(device).type == "cuda" else "gloo")
    if coord:
        dist.init_process_group(backend, init_method=f"tcp://{coord}", world_size=int(os.environ["GEOMRL_NUM_PROCESSES"]),
                                rank=int(os.environ["GEOMRL_PROCESS_ID"]))
    else:
        dist.init_process_group(backend, init_method="env://")
    return True


def local_device(device) -> torch.device:
    """This process's device: for CUDA, card `LOCAL_RANK % device_count`
    (the rank where no `LOCAL_RANK` is set)."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None or not dist.is_initialized():
        return device
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def is_main_process() -> bool:
    """True on the process that owns logging and printing (rank 0)."""
    return not dist.is_initialized() or dist.get_rank() == 0
