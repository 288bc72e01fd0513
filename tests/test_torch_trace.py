"""The port's recorder (`geometry_rl_torch/utils/trace.py`) and the spans and
counters the port's layers put on it, on the CPU at tiny sizes.

- Off (the default) a span is one shared no-op that touches nothing in torch;
  on, spans nest per thread with their parents and self times; counters are
  always on; spans and counts from several threads are all kept; under
  `torch.profiler` each span is a `record_function` range of the same name
  and nesting.
- A 4-env rigid step records `decimation` substeps and, per substep,
  `iterations` solves of each constraint kind; a tiny cloth iteration one KL
  bisection per minibatch step, with no span inside it; the set-up spans
  once each.
- No span of the port has the name of a range that the benchmark puts on
  the port from outside (`benchmark/trace.py`'s `RANGES`).
"""

import os
import re
import threading

import pytest
import torch
import test_torch_common  # noqa: F401  (pins torch to one thread per test worker)

from benchmark.trace import RANGES
from geometry_rl_torch.config import load_config, trainer_from_config
from geometry_rl_torch.envs import make_env
from geometry_rl_torch.utils import trace
from geometry_rl_torch.utils.trace import COUNTERS, count, counting, recording, span, spanned

PORT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "geometry_rl_torch")


def port_span_names():
    """Every span name the port's sources open (`span("...")`, `spanned("...")`)."""
    names = set()
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    names |= set(re.findall(r'\bspan(?:ned)?\("([^"]+)"\)', fh.read()))
    return names


def test_off_is_one_shared_no_op_that_touches_no_torch(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span touched torch while recording was off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", refuse)
    assert trace._recording is None
    assert span("a") is span("b")
    with span("a"):
        with span("b"):
            pass
    assert spanned("c")(lambda x: x + 1)(1) == 2
    assert trace._recording is None


def test_spans_nest_with_parents_and_self_times():
    @spanned("outer")
    def outer():
        with span("inner"):
            sum(range(10000))
        with span("inner"):
            with span("leaf"):
                sum(range(10000))
        sum(range(10000))

    with recording() as rec:
        outer()
    assert [s.name for s in rec.spans] == ["outer", "inner", "inner", "leaf"]
    assert [s.parent for s in rec.spans] == [-1, 0, 0, 2]
    for s in rec.spans:
        assert s.start_ns <= s.end_ns
    o, i1, i2, leaf = rec.spans
    assert o.start_ns <= i1.start_ns and i2.end_ns <= o.end_ns and i2.start_ns <= leaf.start_ns <= leaf.end_ns <= i2.end_ns
    totals = rec.totals()
    assert totals["inner"][0] == 2 and totals["outer"][0] == 1
    dur = {i: (s.end_ns - s.start_ns) / 1e9 for i, s in enumerate(rec.spans)}
    assert totals["outer"][1] == pytest.approx(dur[0])
    assert totals["outer"][2] == pytest.approx(dur[0] - dur[1] - dur[2])
    assert totals["inner"][2] == pytest.approx(dur[1] + dur[2] - dur[3])
    assert totals["leaf"][2] == pytest.approx(totals["leaf"][1])
    # a window: only the spans that start inside it
    assert set(rec.totals(i2.start_ns, i2.end_ns)) == {"inner", "leaf"}
    assert trace._recording is None
    with span("after"):
        pass
    assert len(rec.spans) == 4


def test_one_recording_at_a_time():
    with recording():
        with pytest.raises(RuntimeError, match="already"):
            with recording():
                pass
    assert trace._recording is None


def test_counters_are_always_on():
    before = COUNTERS.get("test.counted", 0)
    count("test.counted")
    count("test.counted", 4)
    assert COUNTERS["test.counted"] == before + 5
    with counting("test.counted", "test.never") as moved:
        count("test.counted", 2)
    assert moved == {"test.counted": 2, "test.never": 0}
    with recording() as rec, counting("test.counted") as moved:
        count("test.counted", 3)
    assert moved == {"test.counted": 3} and rec.spans == []


def test_spans_and_counts_from_many_threads_are_all_kept():
    threads, per = 8, 300
    start = threading.Barrier(threads)

    def work(i):
        start.wait()
        for _ in range(per):
            with span(f"test.outer{i}"):
                with span(f"test.inner{i}"):
                    count("test.threads")

    with recording() as rec, counting("test.threads") as moved:
        pool = [threading.Thread(target=work, args=(i,)) for i in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join()
    assert moved == {"test.threads": threads * per}
    assert len(rec.spans) == 2 * threads * per and None not in rec.spans
    for s in rec.spans:
        if s.name.startswith("test.inner"):
            assert rec.spans[s.parent].name == s.name.replace("inner", "outer")
        else:
            assert s.parent == -1
    totals = rec.totals()
    assert all(totals[f"test.{kind}{i}"][0] == per for kind in ("outer", "inner") for i in range(threads))


def test_spans_are_profiler_ranges_under_the_profiler():
    with recording() as rec, torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("train.outer"):
            with span("train.inner"):
                torch.ones(3) + 1
    events = {e.name: e for e in prof.events() if e.name in ("train.outer", "train.inner")}
    assert set(events) == {"train.outer", "train.inner"}
    assert events["train.inner"].cpu_parent is events["train.outer"]
    assert events["train.outer"].cpu_parent is None or events["train.outer"].cpu_parent.name not in events
    assert [s.name for s in rec.spans] == ["train.outer", "train.inner"]
    # outside the profiler, no range is opened
    with recording() as rec, torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        pass
    assert not [e for e in prof.events() if e.name.startswith("train.")]


def test_a_rigid_step_records_its_substeps_and_solves():
    env = make_env("rigid_insertion", num_envs=4, warmup_steps=0, device="cpu")
    cfg = env.cfg
    state = env.reset(torch.Generator().manual_seed(0))
    action = torch.zeros((4, cfg.action_dim))
    with recording() as rec:
        env.step(state, action)
    totals = rec.totals()
    names = [s.name for s in rec.spans]
    n_contacts = len(env._contacts(state.scene)[0])
    assert n_contacts == 2  # the ground and the hole plate
    assert totals["envs.step"][0] == 1
    for child in ("envs.action", "envs.physics", "envs.reward", "envs.reset_draw", "envs.observe"):
        assert totals[child][0] == 1 and rec.spans[names.index(child)].parent == names.index("envs.step")
    assert totals["sim.substep"][0] == cfg.decimation
    assert totals["sim.integrate"][0] == totals["sim.velocity"][0] == cfg.decimation
    assert totals["sim.joints"][0] == cfg.decimation * cfg.iterations
    assert totals["sim.contacts"][0] == cfg.decimation * cfg.iterations * n_contacts
    assert "sim.pair_contacts" not in totals and "sim.particles" not in totals
    substeps = {i for i, n in enumerate(names) if n == "sim.substep"}
    assert all(rec.spans[i].parent == names.index("envs.physics") for i in substeps)
    assert all(s.parent in substeps for s in rec.spans if s.name.startswith("sim.") and s.name != "sim.substep")
    for i in substeps:  # each substep: one integrate, `iterations` rounds of solves, one velocity pass
        children = [s.name for s in rec.spans if s.parent == i]
        assert children.count("sim.joints") == cfg.iterations
        assert children.count("sim.contacts") == cfg.iterations * n_contacts
        assert children.count("sim.integrate") == children.count("sim.velocity") == 1
    assert len(rec.spans) <= 150


@pytest.mark.parametrize("task", ["rigid_insertion", "rigid_insertion_two_agents", "rigid_pushing", "rigid_sliding"])
def test_a_rigid_env_on_the_cpu_runs_its_physics_eagerly(task):
    """Only on the card is the physics captured into a CUDA graph: on the CPU
    the reset's warm-up and a step run the eager chain, and neither graph
    counter moves."""
    graph = ("sim.physics_graph.captures", "sim.physics_graph.replays")
    with counting(*graph) as moved, recording() as rec:
        env = make_env(task, num_envs=2, warmup_steps=2, device="cpu")
        state = env.reset(torch.Generator().manual_seed(0))
        env.step(state, torch.zeros((2, env.cfg.action_dim)))
    assert env._graph is None
    assert moved == dict.fromkeys(graph, 0)
    assert rec.totals()["sim.substep"][0] == 3 * env.cfg.decimation


def test_a_cloth_iteration_records_one_bisection_per_minibatch_step():
    cfg = load_config("cloth_hanging_multi_hepi_trpl", overrides={
        "env": {"num_envs": 2, "kwargs": {"warmup_steps": 1, "episode_length": 3}},
        "collector": {"frames_per_batch": 8},
        "algorithm": {"latent_dim": 8, "num_ori": 4, "objective": {"mini_batch_size": 4, "ppo_epochs": 1}},
    })
    with recording() as rec:
        trainer = trainer_from_config(cfg, device="cpu")
        state = trainer.init(torch.Generator().manual_seed(0))
        state, _ = trainer.train_iteration(state)
    totals = rec.totals()
    steps = trainer.cfg.ppo_epochs * trainer.num_minibatches
    assert steps == 2
    assert totals["setup.build"][0] == totals["setup.init"][0] == 1
    assert totals["train.minibatch"][0] == totals["train.backward"][0] == totals["train.optimizer"][0] == steps
    assert totals["rl.projection"][0] == totals["rl.kl_bisection"][0] == steps
    names = [s.name for s in rec.spans]
    for i, s in enumerate(rec.spans):
        if s.name == "rl.kl_bisection":
            assert names[s.parent] == "rl.projection"
            assert totals["rl.kl_bisection"][2] == pytest.approx(totals["rl.kl_bisection"][1])  # no span inside
        if s.name in ("train.backward", "train.optimizer", "rl.projection"):
            assert "train.minibatch" in {names[p] for p in ancestors(rec.spans, i)}
        if s.name in ("graphs.build", "models.forward"):
            assert names[s.parent] in ("train.policy", "train.critic")
    # the collect's steps run the kernel path's substeps
    assert totals["envs.step"][0] == trainer.cfg.steps_per_batch
    assert totals["kernels.cloth_solve"][0] == totals["sim.substep"][0]


def ancestors(spans, i):
    while spans[i].parent >= 0:
        i = spans[i].parent
        yield i


def test_no_port_span_takes_a_benchmark_range_name():
    names = port_span_names()
    assert {"envs.step", "train.policy", "rl.kl_bisection", "sim.substep", "setup.build"} <= names
    assert not names & set(RANGES)
