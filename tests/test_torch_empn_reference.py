"""EMPN (`models/ponita_gcn.py`, PonitaGCN) against the benchmark's frozen
plain copy (`benchmark/reference/frozen/models/ponita_gcn.py`), and the
spans and counter of its layers.

On the CPU both run plain PyTorch, so on seeded random weights the forward
and every parameter's gradient are the same bits: the port sums over the
merged CSRs its graph builder made once, the copy over CSRs it makes on
the spot from the merged indices, and the two orders are one."""

import pytest
import torch
import test_torch_common  # noqa: F401  (pins torch to one thread per test worker)

from benchmark import reference
from geometry_rl_torch.config import load_config, trainer_from_config
from geometry_rl_torch.rl.obs_pipeline import obs_norm_step
from geometry_rl_torch.utils.trace import counting, recording

NUM_ENVS = 4
SELECTS = "graphs.merged_csr.selects"


def config(model: str):
    return load_config(f"rigid_insertion_multi_{model}_trpl", overrides={
        "env": {"num_envs": NUM_ENVS, "kwargs": {"warmup_steps": 0, "episode_length": 8}},
        "collector": {"frames_per_batch": 4 * NUM_ENVS},
        "algorithm": {"latent_dim": 8, "num_ori": 4, "objective": {"mini_batch_size": 8}},
    })


@pytest.fixture(scope="module")
def empn_pair():
    cfg = config("empn")
    assert cfg["algorithm"]["dtype"] == "bfloat16"  # the configuration's precision
    port, ref = trainer_from_config(cfg, device="cpu"), reference.build(cfg, "cpu")
    state = port.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(11)
    with torch.no_grad():  # seeded random weights, the same on both sides
        ref_params = dict(ref.policy.backbone.named_parameters())
        for name, p in port.policy.backbone.named_parameters():
            p.copy_(0.5 * torch.randn(p.shape, generator=g))
            ref_params[name].copy_(p)
    _, tobs = obs_norm_step(state.norm, state.obs, update=True)
    return port, ref, tobs


# the collection layout (sample i is env i), and a shuffled minibatch of
# twice the envs, each sample's topology gathered by its env id
SAMPLES = {"collect": None, "shuffled_minibatch": [2, 0, 3, 1, 1, 3, 0, 2]}


@pytest.mark.parametrize("samples", sorted(SAMPLES))
def test_empn_forward_and_gradients_are_the_frozen_copys_bits(empn_pair, samples):
    port, ref, tobs = empn_pair
    env_ids = None if SAMPLES[samples] is None else torch.tensor(SAMPLES[samples])
    if env_ids is not None:
        tobs = {k: v[env_ids] for k, v in tobs.items()}
    results = []
    for trainer in (port, ref):
        backbone = trainer.policy.backbone
        backbone.zero_grad(set_to_none=True)
        graph, feats = trainer.policy_builder.build({k: v.clone() for k, v in tobs.items()}, env_ids)
        out, hidden = backbone(graph, feats)
        g = torch.Generator().manual_seed(5)
        (out * torch.randn(out.shape, generator=g)).sum().add((hidden * torch.randn(hidden.shape, generator=g)).sum()).backward()
        results.append((out, hidden, {n: p.grad for n, p in backbone.named_parameters()}))
    (out_p, hid_p, grad_p), (out_r, hid_r, grad_r) = results
    assert out_p.shape == (tobs["position_vectors"].shape[0], 1, 2, 3)
    assert torch.equal(out_p, out_r) and torch.equal(hid_p, hid_r)
    assert grad_p.keys() == grad_r.keys() and all(g is not None for g in grad_p.values())
    for name, grad in grad_p.items():
        assert torch.equal(grad, grad_r[name]), name


def minibatch_step_recorded(model: str):
    """One minibatch step of a shuffled minibatch, recorded: the spans' totals and how far the counter moved."""
    trainer = trainer_from_config(config(model), device="cpu")
    state = trainer.init(torch.Generator().manual_seed(0))
    state, batch, _ = trainer._collect(state)
    data = trainer._update_data(state, batch)
    mb = trainer._minibatch(data, torch.randperm(4 * NUM_ENVS, generator=torch.Generator().manual_seed(1))[:8])
    with recording() as rec, counting(SELECTS) as moved:
        trainer._minibatch_step(state, mb, 0, state.kl_beta)
    return rec.totals(), moved


def test_an_empn_minibatch_step_records_its_layers_and_one_merged_csr_gather():
    totals, moved = minibatch_step_recorded("empn")
    forwards = totals["train.policy"][0]
    assert forwards == 1
    assert totals["models.conv_next"][0] == 2 * forwards  # both layers, the forward only
    assert totals["graphs.homogenize"][0] == 2  # the policy's and the DeepSets critic's
    assert moved == {SELECTS: forwards}


def test_a_hepi_minibatch_step_runs_no_conv_next_and_no_merged_csr_gather():
    totals, moved = minibatch_step_recorded("hepi")
    assert "models.conv_next" not in totals and totals["graphs.homogenize"][0] == 1  # the critic's
    assert moved == {SELECTS: 0}
