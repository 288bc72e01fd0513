"""No op whose CUDA result depends on the order of its float atomics lies on
the port's training path.

A `TorchDispatchMode` records every aten op of one `_collect` and one
`_update` (backward included) on the CPU, at a small size, for HEPi on the
three task families (with the rigid velocity pass and the two-gripper joints)
and for every message-passing baseline and the Transformer. On the card the
ops below sum a repeated index with float atomics, in another order every
run: `index_add`, `scatter_add`, `scatter_reduce`, an accumulating
`index_put` (the backward of advanced indexing), `embedding_dense_backward`
and a float `cumsum`. None may appear, except at the sites of `ALLOWED`,
each with its reason. The graph sums go through `models/segment.py`, the
XPBD joint and attachment sums through `sim/xpbd.ordered_sum`.
"""

import traceback

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import test_torch_common  # noqa: F401  (one torch thread per worker)
from geometry_rl_torch.models.segment import ON_THE_SPOT
from geometry_rl_torch.train import TrainConfig
from geometry_rl_torch.train.builders import build_agent

aten = torch.ops.aten
ORDER_DEPENDENT = {
    aten.index_add.default, aten.index_add_.default, aten.index_add.out,
    aten.scatter_add.default, aten.scatter_add_.default,
    aten.scatter_reduce.two, aten.scatter_reduce_.two,
    aten.embedding_dense_backward.default,
}
INDEX_PUT = {aten.index_put.default, aten.index_put_.default, aten._index_put_impl_.default}
# (file, function) -> why its order-dependent op is allowed there
ALLOWED = {
    ("sim/xpbd.py", "_solve_distance_group"):
        "a distance group is conflict-free: each particle appears once in it, so index_add writes each row once",
    ("sim/cloth_solve.py", "pair_update"):
        "the plain cloth solve runs on the CPU only (the card runs K1's or K2's port), and its pairs are "
        "conflict-free: a distance group's particles, and the attachments' (`_check_att_once`), appear once",
}


def _site(stack):
    """The innermost (file, function) of the port on the stack."""
    for frame in reversed(stack):
        path = frame.filename.replace("\\", "/")
        if "/geometry_rl_torch/" in path:
            return path.split("/geometry_rl_torch/", 1)[1], frame.name
    return None


class OpRecorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops, self.bad = set(), []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops.add(func)
        bad = func in ORDER_DEPENDENT
        if func in INDEX_PUT:
            bad = bool(kwargs.get("accumulate", args[3] if len(args) > 3 else False))
        if func in (aten.cumsum.default, aten.cumsum_.default) and torch.is_tensor(out) and out.is_floating_point():
            bad = True
        if bad:
            site = _site(traceback.extract_stack())
            if site not in ALLOWED:
                self.bad.append((str(func), site))
        return out


SMALL = dict(num_envs=2, latent_dim=8, num_ori=4)
COMBOS = {
    "cloth_hanging-hepi": ("cloth_hanging", "hepi", {"warmup_steps": 1, "episode_length": 3}),
    "rigid_insertion-hepi": ("rigid_insertion", "hepi", {"warmup_steps": 0, "episode_length": 3}),
    "rigid_pushing-hepi-velocity_pass": ("rigid_pushing", "hepi",
                                         {"warmup_steps": 0, "episode_length": 3, "dynamic_friction_scale": 1.0}),
    "rigid_insertion_two_agents-hepi": ("rigid_insertion_two_agents", "hepi", {"warmup_steps": 0, "episode_length": 3}),
    "rope_closing-hepi": ("rope_closing", "hepi", {"num_links": 10, "rope_length": 1.25, "episode_length": 3}),
    "cloth_hanging-empn": ("cloth_hanging", "empn", {"warmup_steps": 1, "episode_length": 3}),
    "rigid_insertion-transformer": ("rigid_insertion", "transformer", {"warmup_steps": 0, "episode_length": 3}),
    "rigid_insertion-gcn": ("rigid_insertion", "gcn", {"warmup_steps": 0, "episode_length": 3}),
    "rigid_insertion-meshgraphnet": ("rigid_insertion", "meshgraphnet", {"warmup_steps": 0, "episode_length": 3}),
}


@pytest.mark.parametrize("combo", sorted(COMBOS))
def test_training_path_has_no_order_dependent_op(combo):
    task, model, env_kwargs = COMBOS[combo]
    trainer = build_agent(task, model, device="cpu", env_kwargs=env_kwargs, **SMALL,
                          train_cfg=TrainConfig(steps_per_batch=3, ppo_epochs=1, mini_batch_size=3))
    state = trainer.init(torch.Generator().manual_seed(0))
    ON_THE_SPOT["csr"] = 0
    with OpRecorder() as rec:
        state, batch, _ = trainer._collect(state)
        trainer._update(state, batch)
    assert any("backward" in str(op) for op in rec.ops)  # the update's backward was recorded too
    assert rec.bad == [], f"order-dependent ops on the path of {combo}: {rec.bad}"
    assert ON_THE_SPOT["csr"] == 0  # every graph sum found its topology's CSR


def test_recorder_finds_an_order_dependent_op():
    """The recorder itself: an index_add outside the allowed sites and an
    accumulating index_put from an indexing backward are both reported."""
    x = torch.zeros(4, requires_grad=True)
    with OpRecorder() as rec:
        torch.zeros(3).index_add_(0, torch.tensor([0, 0]), torch.ones(2))
        x[torch.tensor([1, 1])].sum().backward()
    assert {op for op, _ in rec.bad} >= {"aten.index_add_.default"}
    assert any("index_put" in op for op, _ in rec.bad)
