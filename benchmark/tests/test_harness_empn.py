"""EMPN's cell and the readers of its layers' spans: a traced run at a test's
size hands each of them something to read; where the port has no such span
(a checkout from before the spans), each reader finds nothing."""

import dataclasses
import time
import types

import pytest

from benchmark import manifest, spans
from benchmark.harness import run_cell
from benchmark.tests.common import SEED, tiny_config

CELL = "rigid_insertion_empn.train"
READERS = {"conv_next_host_ms.train": "models.conv_next", "conv_next_kernels.train": "models.conv_next",
           "homogenize_host_ms.train": "graphs.homogenize"}


def test_a_traced_run_of_the_cell_reads_its_layers(monkeypatch):
    cell = manifest.load_cell(CELL)
    cell = dataclasses.replace(cell, config=tiny_config(cell.config_name))
    seen = {}
    read = manifest.read_per_layer

    def keep(cell_, ctx):
        seen["ctx"] = ctx
        return read(cell_, ctx)

    monkeypatch.setattr(manifest, "read_per_layer", keep)
    r = run_cell(cell, SEED, 1.0, True, "cpu", time.perf_counter())
    assert r["correct"] is True
    for name in READERS:
        assert r["metrics"][name]["value"] >= 0, name
    window = spans.reduce(seen["ctx"])["window"]
    # one policy forward a control step and a minibatch step, two layers each
    ctx = seen["ctx"]
    forwards = ctx.window.attempted * (ctx.control_steps + ctx.minibatch_steps)
    assert window["models.conv_next"]["calls"] == 2 * forwards
    assert window["models.conv_next"]["host_ms"] > 0 and window["graphs.homogenize"]["host_ms"] > 0
    assert "models.conv_next" in ctx.slice.in_span


@pytest.mark.parametrize("reader", sorted(READERS))
def test_a_reader_finds_nothing_where_the_port_has_no_such_span(reader):
    ctx = types.SimpleNamespace(loop="train", spans=spans.Recorded(types.SimpleNamespace(totals=lambda *a: {}), (1, 2)),
                                window=types.SimpleNamespace(attempted=2), control_steps=3, minibatch_steps=5,
                                slice=types.SimpleNamespace(in_span={"train.policy": (9, 0.1)}, control_steps=3,
                                                            minibatch_steps=10))
    assert manifest.reader(reader)(ctx) is None
    ctx.spans, ctx.slice = None, None  # an untraced run
    assert manifest.reader(reader)(ctx) is None
    ctx.loop = "rollout"
    assert manifest.reader(reader)(ctx) is None
