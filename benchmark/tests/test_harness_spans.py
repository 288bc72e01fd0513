"""The port's spans in a traced run: the harness records them from set-up to
the window's close and hands them to the readers; a run with the trace off
records none; the second pass's reduction gives each span's kernels (its
own and its descendants') and names idle gaps by the innermost of the
ranges and the spans."""

import dataclasses
import time
import types

import pytest
import torch

from benchmark import manifest, spans
from benchmark.harness import run_cell
from benchmark.tests.common import SEED, tiny_config
from benchmark.trace import reduce_spans

CELLS = [w["name"] for w in manifest.load_manifest()["workloads"]]
SPAN_READERS = {  # reader -> the span it reads
    "kl_bisection_host_ms.train": "rl.kl_bisection", "backward_host_ms.train": "train.backward",
    "optimizer_host_ms.train": "train.optimizer", "physics_host_ms.rollout": "envs.physics",
    "physics_kernels.rollout": "envs.physics", "setup_build_s.train": "setup.build",
    "setup_build_s.rollout": "setup.build", "setup_init_s.train": "setup.init", "setup_init_s.rollout": "setup.init",
}


def _traced(cell_name, monkeypatch, trace=True):
    """A run of the cell at a test's size; the readers' Context, or None where no reader ran."""
    cell = manifest.load_cell(cell_name)
    cell = dataclasses.replace(cell, config=tiny_config(cell.config_name))
    seen = {}
    read = manifest.read_per_layer

    def keep(cell_, ctx):
        seen["ctx"] = ctx
        return read(cell_, ctx)

    monkeypatch.setattr(manifest, "read_per_layer", keep)
    r = run_cell(cell, SEED, 1.0, trace, "cpu", time.perf_counter())
    return r, seen.get("ctx")


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_hands_the_spans_to_the_readers(cell, monkeypatch):
    from geometry_rl_torch.utils import trace as port_trace

    r, ctx = _traced(cell, monkeypatch)
    assert r["correct"] is True
    assert port_trace._recording is None  # the recording is closed
    assert isinstance(ctx.spans, spans.Recorded)
    start, end = ctx.spans.window_ns
    assert start < end
    reduced = spans.reduce(ctx)
    assert reduced["setup"]["setup.build"]["calls"] == 1 and reduced["setup"]["setup.init"]["calls"] == 1
    assert "setup.build" not in reduced["window"]
    loop = manifest.load_cell(cell).loop
    reached = {"train": ("rl.kl_bisection", "train.backward", "train.optimizer"), "rollout": ("envs.physics",)}[loop]
    for name in reached:
        assert reduced["window"][name]["calls"] > 0 and reduced["window"][name]["host_ms"] > 0
    assert "envs.physics" in ctx.slice.in_span  # the second pass recorded the spans
    for reader, span in SPAN_READERS.items():
        value = manifest.reader(reader)(ctx)
        if reader.endswith(f".{loop}"):
            assert isinstance(value, float) and value >= 0, reader
        else:
            assert value is None, reader  # another loop's span: nothing to read
    listed = {m["name"] for m in manifest.load_cell(cell).per_layer} & set(SPAN_READERS)
    assert listed <= set(r["metrics"])  # each span reader of the cell reads


def test_a_reader_finds_nothing_where_its_span_is_absent():
    ctx = types.SimpleNamespace(loop="train", spans=spans.Recorded(types.SimpleNamespace(totals=lambda *a: {}), (1, 2)),
                                window=types.SimpleNamespace(attempted=2), control_steps=3, minibatch_steps=5,
                                slice=types.SimpleNamespace(in_span={}, control_steps=1, minibatch_steps=1))
    for reader in SPAN_READERS:
        assert manifest.reader(reader)(ctx) is None, reader
    ctx.spans = None
    assert spans.reduce(ctx) is None


def test_a_run_with_the_trace_off_records_no_spans(monkeypatch):
    from geometry_rl_torch.utils import trace as port_trace

    def refused():
        raise AssertionError("a recording was built")

    monkeypatch.setattr(port_trace, "recording", refused)
    r, ctx = _traced(CELLS[0], monkeypatch, trace=False)
    assert r["correct"] is True and ctx is None and "breakdown" not in r


def test_spans_per_step_of_the_window():
    rec = types.SimpleNamespace(totals=lambda start, end=None: (
        {"setup.init": (1, 2.0, 1.0)} if start == 0 else {"train.backward": (10, 0.05, 0.05)}))
    ctx = types.SimpleNamespace(loop="train", spans=spans.Recorded(rec, (100, 200)),
                                window=types.SimpleNamespace(attempted=2), control_steps=3, minibatch_steps=5)
    reduced = spans.reduce(ctx)
    assert reduced["setup"] == {"setup.init": {"calls": 1, "host_s": 2.0}}
    w = reduced["window"]["train.backward"]
    assert w["calls"] == 10 and w["host_ms"] == pytest.approx(50.0)
    assert w["host_ms_per_minibatch_step"] == pytest.approx(5.0) and w["host_ms_per_control_step"] == pytest.approx(50 / 6)
    assert spans.host_ms_per_step(ctx, "train", "train.backward", "minibatch") == pytest.approx(5.0)
    assert spans.host_ms_per_step(ctx, "rollout", "train.backward", "control") is None
    assert spans.setup_s(ctx, "train", "setup.init") == 2.0


CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def ev(name, start, end, device, thread=1, id=0, annotation=False):
    return types.SimpleNamespace(name=name, device_type=device, is_user_annotation=annotation, thread=thread, id=id,
                                 time_range=types.SimpleNamespace(start=start, end=end))


def test_a_spans_kernels_are_its_own_and_its_descendants():
    events = [
        ev("env.step", 0, 100, CPU, annotation=True),  # a range
        ev("envs.step", 1, 99, CPU, id=1, annotation=True),  # a span inside it ...
        ev("envs.physics", 10, 50, CPU, id=2, annotation=True),  # ... and one inside that
        ev("sim.substep", 20, 40, CPU, id=3, annotation=True),
        ev("aten::mul", 21, 22, CPU, id=41),  # an op: its id is another count than the runtime's
        ev("cudaLaunchKernel", 21.5, 21.9, CPU, id=41),
        ev("cudaGraphLaunch", 45, 46, CPU, id=42),  # a graph's kernels share their replay's id
        ev("cudaLaunchKernel", 60, 61, CPU, id=43),
        ev("cudaLaunchKernel", 60, 61, CPU, thread=2, id=44),  # another thread, inside no span
        ev("envs.physics", 30, 45, CUDA, annotation=True),  # a mirror
        ev("k_mul", 30, 32, CUDA, id=41), ev("k_graph1", 33, 40, CUDA, id=42), ev("k_graph2", 40, 45, CUDA, id=42),
        ev("k_add", 70, 72, CUDA, id=43),  # in envs.step only
        ev("k_other", 80, 81, CUDA, id=44), ev("k_lost", 90, 91, CUDA, id=77),
    ]
    in_span, gaps = reduce_spans(events, {"envs.step", "envs.physics", "sim.substep", "train.policy"})
    assert in_span["envs.physics"] == (3, pytest.approx(14 / 1e6))
    assert in_span["sim.substep"] == (1, pytest.approx(2 / 1e6))
    assert in_span["envs.step"] == (4, pytest.approx(16 / 1e6))
    assert in_span["train.policy"] == (0, 0.0)
    # gaps: 32..33 at 32.5 (sim.substep is innermost), 45..70 at 57.5 (envs.step), 72..80 at 76, 81..90 at 85.5
    assert dict((k, round(v * 1e6, 6)) for k, v in gaps) == {"sim.substep": 1, "envs.step": 25 + 8 + 9}
