"""One-shot kernel calibration for PONITA convolutions (port of
`geometry_rl_tpu/models/calibration.py`).

One forward pass records the activation stds of each conv (FiberBundleConv,
SeparableFiberBundleConvNext) on its first call, then every conv is rescaled
so each stage preserves feature std:
kernel *= std_in / std_1, fiber_kernel *= std_1 / std_2.
"""

from __future__ import annotations

import torch
from torch import nn

from .ponita import FiberBundleConv, SeparableFiberBundleConvNext


@torch.no_grad()
def calibrate(model: nn.Module, *args, **kwargs) -> None:
    """Rescale, in place, the kernels of every PONITA conv in `model`; a model
    without one is left as it is (and is not run)."""
    convs = [m for m in model.modules() if isinstance(m, (FiberBundleConv, SeparableFiberBundleConvNext))]
    if not convs:
        return
    for conv in convs:
        conv.calib_stats = []
    try:
        model(*args, **kwargs)
        stats = [conv.calib_stats for conv in convs]
    finally:
        for conv in convs:
            conv.calib_stats = None
    for conv, calls in zip(convs, stats):
        if not calls:
            continue
        std_in, std_1, std_2 = calls[0]
        std_1, std_2 = torch.clamp(std_1, min=1e-8), torch.clamp(std_2, min=1e-8)
        conv.kernel.weight.mul_(std_in / std_1)
        conv.fiber_kernel.weight.mul_(std_1 / std_2)
