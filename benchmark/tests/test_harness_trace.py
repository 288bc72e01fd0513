"""The trace's reduction on events made by hand: kernels inside a range's
device mirror, idle gaps named by the host's range."""

import types

import torch

from benchmark.trace import Calls, reduce_events

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def ev(name, start, end, device, annotation=False):
    return types.SimpleNamespace(name=name, device_type=device, is_user_annotation=annotation,
                                 time_range=types.SimpleNamespace(start=start, end=end))


def test_reduce_events():
    events = [
        ev("env.step", 0, 100, CPU, True), ev("policy", 100, 160, CPU, True),
        ev("env.step", 10, 60, CUDA, True),  # the range's mirror on the device
        ev("k1", 10, 20, CUDA), ev("k2", 30, 60, CUDA),  # inside env.step
        ev("k3", 120, 150, CUDA),  # after an idle gap the host spent in `policy`... (60..120 midpoint 90: env.step)
        ev("policy", 120, 150, CUDA, True),
        ev("aten::add", 5, 6, CPU),
    ]
    calls = {"segment_sum": Calls(), "cloth_solve": Calls()}
    s = reduce_events(events, 200e-6, {"control_steps": 1, "minibatch_steps": 0}, calls)
    assert s.kernels == 3
    assert s.busy_s == (10 + 30 + 30) / 1e6
    assert s.in_range["env.step"] == (2, 40 / 1e6)
    assert s.in_range["policy"] == (1, 30 / 1e6)
    assert s.in_range["critic"] == (0, 0.0)
    assert dict((k, round(v * 1e6, 6)) for k, v in s.idle_gaps) == {"env.step": 10 + 60}
    assert [name for name, _ in s.device_ops] == ["k2", "k3", "k1"]
