"""The frozen work counts equal the port's counts at small shapes, and the
FLOP count does not depend on the port's code."""

import copy

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.counts import cloth_solve, flops, segment_sum
from benchmark.tests.common import SEED, tiny_config


def test_cloth_solve_cost_is_the_ports():
    from geometry_rl_torch.config import trainer_from_config
    from geometry_rl_torch.sim.cloth_solve import solve_cost

    env = trainer_from_config(tiny_config("cloth_hanging_hepi_trpl"), device="cpu").env
    for B in (1, 2, 100):
        for contacts, hits in ((0, 0), (7, 3)):
            assert cloth_solve.solve_cost(env.solve_spec, B, contacts, hits) == solve_cost(env.solve_spec, B, contacts, hits)


def test_segment_sum_bytes_are_the_ports():
    """The bytes `kernel_bench.py` bounds the kernel by, on a CSR of the
    port's cloth graph: values, perm and offsets read once, output written once."""
    from geometry_rl_torch.config import trainer_from_config

    tr = trainer_from_config(tiny_config("cloth_hanging_hepi_trpl"), device="cpu")
    state = tr.init(torch.Generator().manual_seed(SEED))
    from geometry_rl_torch.rl.obs_pipeline import obs_norm_step

    _, tobs = obs_norm_step(state.norm, state.obs, update=False)
    graph, _ = tr.policy_builder.build(tobs)
    edges = next(iter(graph.edges.values()))
    csr = edges.dst_csr
    B, E, F = tr.env.cfg.num_envs, edges.src.shape[-1], 1024
    values = torch.zeros((B, E, F), dtype=torch.bfloat16)
    elt = values.element_size()
    port = values.numel() * elt + 4 * csr.perm.numel() + 4 * csr.offsets.numel() + B * csr.num_segments * F * elt
    assert segment_sum.segment_sum_bytes((B, E, F), elt, csr.perm.numel(), csr.offsets.numel(), csr.num_segments) == port


def _port_flops(cfg):
    """FlopCounterMode over the port's own plain path (the CPU's), as `count` takes it."""
    from geometry_rl_torch.config import trainer_from_config
    from geometry_rl_torch.rl import gaussian as G
    from geometry_rl_torch.rl.obs_pipeline import obs_norm_step

    tr = trainer_from_config(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    state = tr.init(gen)
    with torch.no_grad():
        _, tobs = obs_norm_step(state.norm, state.obs, update=True)
        with FlopCounterMode(display=False) as c:
            dist = tr._policy_dist(tobs)
            action = G.sample(gen, dist)
            G.log_prob(dist, action)
            tr._value(tobs)
            tr.env.step(state.env_state, action)
    return c.get_total_flops()


def test_the_flop_count_is_the_ports_plain_work_and_not_the_ports_code(monkeypatch):
    cfg = tiny_config("rigid_insertion_hepi_trpl")
    n = flops.SIZES[0]
    cfg["env"]["num_envs"] = n
    cfg["collector"]["frames_per_batch"] = 2 * n
    cfg["algorithm"]["objective"]["mini_batch_size"] = n
    port = _port_flops(copy.deepcopy(cfg))
    assert port > 0
    import geometry_rl_torch.models.common as port_common

    def broken(*args, **kwargs):
        raise AssertionError("the count ran the port's code")

    monkeypatch.setattr(port_common, "segment_sum", broken)  # the port's kernel entry, whatever it runs
    counted = flops.count(cfg, "cpu")
    assert counted["collect"] == port
    assert counted["rollout"] > 0 and counted["update"] > 0


def test_the_count_is_a_line_in_the_batch():
    cfg = tiny_config("cloth_hanging_hepi_trpl")
    n = 24
    at_n = flops._count_at(cfg, n, "cpu")
    big = copy.deepcopy(cfg)
    big["env"]["num_envs"] = n
    big["algorithm"]["objective"]["mini_batch_size"] = n
    assert flops.count(big, "cpu") == {k: float(v) for k, v in at_n.items()}
