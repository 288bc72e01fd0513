"""The frozen reference against the port at small sizes on the CPU, where
both run plain PyTorch: the same bits through reset, env steps, the policy
and critic forwards, a whole training iteration (collect, GAE, TRPL with its
KL projection, backward, Adam) and the evaluation rollout, for every
configuration with test sizes (`tests/tiny/`). And what the benchmark's modules import."""

import ast
from pathlib import Path

import pytest
import torch

from benchmark import manifest, reference
from benchmark.manifest import HERE
from benchmark.tests.common import SEED, TINY_CONFIGS, tiny_config

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "geometry_rl_tpu"}


def _imports(path: Path):
    """Top-level names of the absolute imports in `path`."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")), ids=lambda p: str(p.relative_to(HERE)))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")), ids=lambda p: str(p.relative_to(HERE)))
def test_the_reference_imports_nothing_of_the_port(path):
    assert "geometry_rl_torch" not in set(_imports(path))


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return True


def _pair(name):
    from geometry_rl_torch.config import trainer_from_config

    cfg = tiny_config(name)
    port, ref = trainer_from_config(cfg, device="cpu"), reference.build(cfg, "cpu")
    gen = lambda: torch.Generator().manual_seed(SEED)  # noqa: E731
    return port, port.init(gen()), ref, ref.init(gen())


def test_every_configuration_of_the_benchmark_has_test_sizes():
    """So that the bit-equality tests below take every configuration."""
    assert {c["name"] for c in manifest.load_manifest()["configs"]} <= set(TINY_CONFIGS)


@pytest.mark.parametrize("name", TINY_CONFIGS)
def test_init_and_a_training_iteration_are_the_same_bits(name):
    port, ps, ref, rs = _pair(name)
    assert _equal(ps.obs, rs.obs) and _equal(ps.env_state, rs.env_state)
    for mp, mr in ((port.policy, ref.policy), (port.critic, ref.critic)):
        assert _equal(dict(mp.named_parameters()), dict(mr.named_parameters()))
    ps, pm = port.train_iteration(ps)
    rs, rm = ref.train_iteration(rs)
    for k in pm:
        if not k.endswith("_time"):
            assert torch.equal(pm[k].nan_to_num(7.0), rm[k].nan_to_num(7.0)), k
    for mp, mr in ((port.policy, ref.policy), (port.critic, ref.critic)):
        assert _equal(dict(mp.named_parameters()), dict(mr.named_parameters()))
    assert _equal(ps.env_state, rs.env_state) and _equal(ps.norm, rs.norm)


@pytest.mark.parametrize("name", TINY_CONFIGS)
def test_the_evaluation_rollout_is_the_same_bits(name):
    port, ps, ref, rs = _pair(name)
    with torch.no_grad():
        for tp, tr in zip(port._eval_steps(ps, 4, True, 7), ref._eval_steps(rs, 4, True, 7)):
            assert _equal(tp.obs, tr.obs) and torch.equal(tp.reward, tr.reward) and torch.equal(tp.done, tr.done)


@pytest.mark.parametrize("name", TINY_CONFIGS)
def test_the_reference_steps_from_the_ports_state(name):
    """`to_reference` carries a port state (NamedTuples, generators) over to
    the reference's types, and the step from it is the port's."""
    port, ps, ref, _ = _pair(name)
    action = torch.randn((port.env.cfg.num_envs, port.env.cfg.action_dim), generator=torch.Generator().manual_seed(3))
    copy = reference.to_reference(ps.env_state)
    assert type(copy).__module__.startswith("benchmark.reference.frozen")
    _, ts = port.env.step(ps.env_state, action)
    _, ts_ref = ref.env.step(copy, action)
    assert _equal(ts.obs, ts_ref.obs) and torch.equal(ts.reward, ts_ref.reward)


def test_the_control_rounds_dense_inputs_to_float8_and_the_env_to_bfloat16():
    x = torch.tensor([1.0 + 2**-6, 3.3, -500.0], requires_grad=True)
    y = reference.fp8_round(x)
    assert y.tolist() == [1.0, 3.25, -448.0]
    y.sum().backward()
    assert x.grad.tolist() == [1.0, 1.0, 1.0]  # straight through
    assert reference.bf16_round({"a": torch.tensor([1.0 + 2**-10])})["a"].item() == 1.0
