"""The port's fixed-order sums against the JAX package, on the CPU.

- `csr_from_index` against numpy's stable argsort and searchsorted.
- The plain segment sum (`models/segment.segment_sum_ref`) against a
  sequential numpy sum in the CSR's order: bit for bit, which is also what the
  kernel (`csrc/segment_sum.cu`) is held to on the card.
- `scatter_sum` and `gather_nodes` (now `torch.autograd.Function`s over the
  segment sum), forward and gradient, against the JAX package's, on both of
  its branches: the one-hot contraction (N <= MATMUL_GATHER_MAX_NODES = 512)
  and `take` / `segment_sum` (N > 512). Inputs hold empty segments, masked
  edges, nodes that receive a full edge set (the cloth's `task` edges: every
  hole-boundary node into every gripper) and per-env topologies that differ
  (the rigid kNN graphs of shapes with 6 to 32 points, padded edges on node
  0). Tolerances: f32 within 1e-6 of the scale (sums in another order); bf16
  within one bf16 unit in the last place of the reference, the rounding of one
  final cast of two f32 sums that are 1e-6 apart (one-hot branch only: past
  512 nodes the JAX package adds in bf16).
- The graph builders' merged CSRs (`HeteroGraph.merged_csr`, made once with
  the topology for EMPN, GCN and MeshGraphNet) against the stable sort of
  `homogenize`'s merged indices, for the collect and a shuffled minibatch.
- The XPBD joint and attachment sums (`sim/xpbd.ordered_sum`) against the
  JAX package where one body takes three joints or three attachments and one
  particle two, at tests/test_torch_particle_sim.py's 1e-5.
- The kernel's launch plan (`models/segment.launch_plan`, pure Python): every
  segment sum of the HEPi main paths' collects and updates takes the 16-byte
  route with a grid that fills the card; rows that are not a multiple of 16
  bytes and unaligned pointers take the scalar route; the shared memory stays
  within the limit the plan declares.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (one torch thread per worker)
from geometry_rl_tpu.models import common as jax_common
from geometry_rl_tpu.sim import xpbd as jax_xpbd
from geometry_rl_tpu.sim.types import FixedJointSpec as JaxJoints
from geometry_rl_torch.graphs.cloth import _full_pairs
from geometry_rl_torch.graphs.homogenize import homogenize
from geometry_rl_torch.graphs.rigid import knn_graph_batch
from geometry_rl_torch.graphs.types import CSR, csr_from_index
from geometry_rl_torch.models.common import gather_nodes, scatter_mean, scatter_sum
from geometry_rl_torch.config import load_config, trainer_from_config
from geometry_rl_torch.models import common as torch_common
from geometry_rl_torch.models.segment import (
    CTAS_PER_SM,
    H100_SMS,
    MAX_TILE_BYTES,
    ON_THE_SPOT,
    RING_BYTES,
    MIN_GROUP_ROWS,
    SMEM_LIMIT,
    STAGES,
    launch_plan,
    segment_sum,
    segment_sum_ref,
)
from geometry_rl_torch.rl.obs_pipeline import obs_norm_apply
from geometry_rl_torch.sim import xpbd
from geometry_rl_torch.sim.types import FixedJointSpec
from geometry_rl_torch.train import TrainConfig
from geometry_rl_torch.train.builders import build_agent
from geometry_rl_torch.utils.trace import counting
from test_torch_particle_sim import body_spec_arrays, specs, tilted_quats

F32_TOL = 1e-6
BF16_ULP = 2.0 ** -7  # one unit in the last place of a bf16 value, relative to its magnitude


def cloth_task_topology(B):
    """10 hole-boundary nodes -> 4 grippers, every pair: each gripper receives all 10."""
    src, dst = _full_pairs(10, 4, False, "cpu")
    return src.expand(B, -1).numpy(), dst.expand(B, -1).numpy(), 10, 4


def rigid_knn_topology(B, rng):
    """Per-env kNN topologies of shapes with 6 to 32 points: padded edges sit on node 0."""
    counts = np.array([6, 32, 17, 11, 24, 8])[:B]
    points = rng.normal(size=(B, 32, 3)).astype(np.float32)
    src, dst, mask = knn_graph_batch(points, counts, 3)
    return src.astype(np.int64), dst.astype(np.int64), 32, 32, mask


def large_topology(B, rng):
    """600 nodes (the `take` branch of the JAX package), 900 random edges: most nodes get none or one."""
    src = rng.integers(0, 600, (B, 900))
    dst = rng.integers(0, 600, (B, 900))
    return src, dst, 600, 600


def topology(name, B, rng):
    """(src, dst, n_src, n_dst, mask) of a named test topology; 1 in 5 edges masked where none is padded."""
    if name == "rigid":
        return rigid_knn_topology(B, rng)
    src, dst, n_src, n_dst = cloth_task_topology(B) if name == "cloth_task" else large_topology(B, rng)
    return src, dst, n_src, n_dst, (rng.uniform(size=src.shape) > 0.2).astype(np.float32)


def test_csr_from_index_is_numpys_stable_sort():
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 7, (5, 40))
    idx[2] = 3  # one env whose edges all go to one node
    csr = csr_from_index(torch.as_tensor(idx), 9)
    order = np.argsort(idx, axis=-1, kind="stable")
    np.testing.assert_array_equal(csr.perm.numpy(), order)
    sorted_idx = np.take_along_axis(idx, order, -1)
    np.testing.assert_array_equal(csr.offsets.numpy(), [np.searchsorted(r, np.arange(10), "left") for r in sorted_idx])
    assert csr.perm.dtype == csr.offsets.dtype == torch.int32 and csr.num_segments == 9
    shared = csr_from_index(torch.as_tensor(idx[0]), 9)  # one topology for every env
    assert shared.perm.shape == (1, 40) and shared.select(torch.tensor([1, 0, 1])) is shared
    picked = csr.select(torch.tensor([4, 2]))
    np.testing.assert_array_equal(picked.perm.numpy(), order[[4, 2]])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["cloth_task", "rigid"])
def test_plain_segment_sum_adds_in_csr_order(name, dtype):
    """Bit for bit the sum a thread of the kernel makes: 0.0f, then each row
    in perm order, in f32, rounded once to the values' type."""
    rng = np.random.default_rng(1)
    B = 4
    _, dst, _, n, _ = topology(name, B, rng)
    vals = torch.as_tensor(rng.normal(size=(B, dst.shape[1], 5)).astype(np.float32)).to(dtype)
    csr = csr_from_index(torch.as_tensor(dst), n)
    with counting("kernels.segment_sum") as launched:
        got = segment_sum(vals, csr)
    assert launched == {"kernels.segment_sum": 0}  # a CPU tensor takes the plain version
    v, perm, off = vals.float().numpy(), csr.perm.numpy(), csr.offsets.numpy()
    want = np.zeros((B, n, 5), np.float32)
    for b in range(B):
        for m in range(n):
            acc = np.zeros(5, np.float32)
            for k in range(off[b, m], off[b, m + 1]):
                acc = acc + v[b, perm[b, k]]
            want[b, m] = acc
    np.testing.assert_array_equal(got.float().numpy(), torch.as_tensor(want).to(dtype).float().numpy())
    assert got.dtype == dtype and (np.diff(off, axis=-1) == 0).any() == (name == "rigid")  # rigid: empty segments


def test_plain_segment_sum_shared_and_empty():
    """A CSR shared by every env serves a batch of any size; no edge at all gives zeros."""
    vals = torch.randn(3, 4, 2)
    shared = csr_from_index(torch.tensor([2, 0, 2, 2]), 3)
    per_env = csr_from_index(torch.tensor([[2, 0, 2, 2]] * 3), 3)
    assert torch.equal(segment_sum_ref(vals, shared), segment_sum_ref(vals, per_env))
    assert torch.equal(segment_sum_ref(vals, shared)[:, 1], torch.zeros(3, 2))
    none = segment_sum_ref(torch.zeros(3, 0, 2), csr_from_index(torch.zeros(3, 0, dtype=torch.long), 5))
    assert none.shape == (3, 5, 2) and not none.any()


def _assert_matches(got, ref, dtype, what):
    got, ref = got.float().numpy(), np.asarray(jnp.asarray(ref, jnp.float32))
    scale = max(1.0, np.abs(ref).max())
    if dtype == torch.float32:
        assert np.abs(got - ref).max() <= F32_TOL * scale, what
    else:
        assert (np.abs(got - ref) <= BF16_ULP * np.abs(ref) + F32_TOL * scale).all(), what


# past 512 nodes the JAX package's segment_sum adds in bf16, not in f32 with one final cast: f32 only there
@pytest.mark.parametrize("name,dtype", [("cloth_task", torch.float32), ("cloth_task", torch.bfloat16),
                                        ("rigid", torch.float32), ("rigid", torch.bfloat16), ("large", torch.float32)])
def test_scatter_and_gather_match_reference(name, dtype):
    """Forward and gradient of scatter_sum, scatter_mean and gather_nodes
    against the JAX package, with the topology's CSRs and without (made on
    the spot: the same bits)."""
    rng = np.random.default_rng(2)
    B, O, C = 3, 4, 8
    src, dst, n_src, n_dst, mask = topology(name, B, rng)
    assert (n_dst <= jax_common.MATMUL_GATHER_MAX_NODES) == (name != "large")
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    x = rng.normal(size=(B, n_src, O, C)).astype(np.float32)
    msg = (rng.normal(size=(B, src.shape[1], O, C)) * mask[..., None, None]).astype(np.float32)
    cot_nodes = rng.normal(size=(B, n_dst, O, C)).astype(np.float32)
    cot_edges = rng.normal(size=(B, src.shape[1], O, C)).astype(np.float32)
    src_csr, dst_csr = csr_from_index(torch.as_tensor(src), n_src), csr_from_index(torch.as_tensor(dst), n_dst)
    js, jd = jnp.asarray(src), jnp.asarray(dst)

    ref_scatter, vjp_scatter = jax.vjp(lambda m: jax_common.scatter_sum(m, jd, n_dst), jnp.asarray(msg, jdt))
    (ref_scatter_grad,) = vjp_scatter(jnp.asarray(cot_nodes, jdt))
    ref_gather, vjp_gather = jax.vjp(lambda v: jax_common.gather_nodes(v, js), jnp.asarray(x, jdt))
    (ref_gather_grad,) = vjp_gather(jnp.asarray(cot_edges, jdt))
    ref_mean = jax_common.scatter_mean(jnp.asarray(msg, jdt), jd, n_dst, jnp.asarray(mask, jdt))

    outs = []
    for csrs in ((src_csr, dst_csr), (None, None)):
        ON_THE_SPOT["csr"] = 0
        tm = torch.tensor(msg, dtype=dtype, requires_grad=True)
        tx = torch.tensor(x, dtype=dtype, requires_grad=True)
        scattered = scatter_sum(tm, torch.as_tensor(dst), n_dst, csrs[1])
        gathered = gather_nodes(tx, torch.as_tensor(src), csrs[0])
        (scattered * torch.tensor(cot_nodes, dtype=dtype)).sum().backward()
        (gathered * torch.tensor(cot_edges, dtype=dtype)).sum().backward()
        mean = scatter_mean(torch.tensor(msg, dtype=dtype), torch.as_tensor(dst), n_dst,
                            torch.tensor(mask, dtype=dtype), csrs[1])
        assert ON_THE_SPOT["csr"] == (0 if csrs[0] is not None else 4)
        outs.append((scattered, tm.grad, gathered, tx.grad, mean))
        for got, ref, what in ((scattered, ref_scatter, "scatter_sum"), (tm.grad, ref_scatter_grad, "its gradient"),
                               (gathered, ref_gather, "gather_nodes"), (tx.grad, ref_gather_grad, "its gradient"),
                               (mean, ref_mean, "scatter_mean")):
            assert got.dtype == dtype
            _assert_matches(got.detach(), ref, dtype, f"{what} ({name}, {dtype})")
    for a, b in zip(*outs):
        assert torch.equal(a, b)  # the CSR made on the spot is the topology's


def test_scatter_of_masked_edges_adds_nothing():
    """A node that receives only masked edges gets exactly 0 (rigid padding
    piles its edges on node 0 of a small shape, which has real edges too)."""
    rng = np.random.default_rng(3)
    src, dst, _, n, mask = rigid_knn_topology(2, rng)
    msg = torch.as_tensor(rng.normal(size=(2, dst.shape[1], 3)).astype(np.float32)) * torch.as_tensor(mask)[..., None]
    got = scatter_sum(msg, torch.as_tensor(dst), n, csr_from_index(torch.as_tensor(dst), n))
    real = np.zeros((2, n, 3), np.float32)
    for b in range(2):
        for e in np.flatnonzero(mask[b]):
            real[b, dst[b, e]] += msg[b, e].numpy()
    np.testing.assert_allclose(got.numpy(), real, atol=1e-6)
    assert not got[0, 6:].any()  # the 6-point shape's padded nodes receive nothing


MERGED_TASKS = {
    "cloth_hanging": {"warmup_steps": 1}, "rigid_insertion": {"warmup_steps": 0},
    "rigid_insertion_two_agents": {"warmup_steps": 0}, "rope_closing": {"num_links": 10, "rope_length": 1.25},
}


@pytest.mark.parametrize("task", sorted(MERGED_TASKS))
def test_builders_merged_csr_is_homogenizes_order(task):
    """Each builder's graph hands out the CSRs of its merged edge set, made
    once with the builder: the same as a stable sort of `homogenize`'s merged
    src and dst, for the policy's and the critic's graphs (the cloth critic's
    adds the particle nodes), in the collect and in a shuffled minibatch (the
    rigid CSRs are each env's); none is made on the spot."""
    trainer = build_agent(task, "empn", device="cpu", env_kwargs=MERGED_TASKS[task], num_envs=3, latent_dim=8,
                          num_ori=4, train_cfg=TrainConfig(steps_per_batch=2, mini_batch_size=2))
    state = trainer.init(torch.Generator().manual_seed(0))
    tobs = obs_norm_apply(state.norm, state.obs)
    env_ids = torch.tensor([2, 0, 2, 1])
    for builder in (trainer.policy_builder, trainer.critic_builder):
        for ids in (None, env_ids):
            graph, _ = builder.build(tobs if ids is None else {k: v[ids] for k, v in tobs.items()}, ids)
            ON_THE_SPOT["csr"] = 0
            homo = homogenize(graph, with_csr=True)
            assert ON_THE_SPOT["csr"] == 0
            n = homo.pos.shape[1]
            for got, idx in ((homo.edges.src_csr, homo.edges.src), (homo.edges.dst_csr, homo.edges.dst)):
                want = csr_from_index(idx, n)
                assert torch.equal(got.perm.expand_as(want.perm), want.perm)
                assert torch.equal(got.offsets.expand_as(want.offsets), want.offsets)


# ------------------------------------------------------------ XPBD sums


def test_sum_order_and_ordered_sum():
    order = xpbd.sum_order(torch.tensor([2, 0, 2, 2]), 4)
    assert order.tolist() == [[1, 4, 4], [4, 4, 4], [0, 2, 3], [4, 4, 4]]
    rows = torch.randn(2, 4, 3)
    got = xpbd.ordered_sum(xpbd.with_zero_row(rows), order)
    want = torch.stack([rows[:, 1], torch.zeros(2, 3), rows[:, 0] + rows[:, 2] + rows[:, 3], torch.zeros(2, 3)], 1)
    assert torch.equal(got, want)


def test_three_joints_on_one_body_match_reference():
    """Three grippers welded to one object (each correction scaled by 1/3 of
    the object's), the joint order made on the spot and made once: the same."""
    rng = np.random.default_rng(40)
    B, NB = 3, 4
    arrays = body_spec_arrays(rng, NB, locked=False)
    jspec, tspec = specs(arrays)
    body_a, body_b = np.int64([0, 1, 2]), np.int64([3, 3, 3])
    lpa = rng.uniform(-0.05, 0.05, (3, 3)).astype(np.float32)
    lpb = rng.uniform(-0.05, 0.05, (3, 3)).astype(np.float32)
    rel = tilted_quats(rng, (3,), scale=0.05)
    pos = rng.uniform(-0.1, 0.1, (B, NB, 3)).astype(np.float32)
    quat = tilted_quats(rng, (B, NB), scale=0.1)
    jj = JaxJoints(*(jnp.asarray(a) for a in (body_a, body_b, lpa, lpb, rel)))
    tj = FixedJointSpec(*(torch.as_tensor(a) for a in (body_a, body_b, lpa, lpb, rel)))
    jp, jq = jax_xpbd._solve_fixed_joints(jnp.asarray(pos), jnp.asarray(quat), jspec, jj)
    made = xpbd.joint_sum_order(tj, NB)
    assert made.sum_order.tolist() == [[0, 6, 6], [1, 6, 6], [2, 6, 6], [3, 4, 5]]
    for joints in (tj, made):
        tp, tq = xpbd._solve_fixed_joints(torch.as_tensor(pos), torch.as_tensor(quat), tspec, joints)
        assert np.abs(np.asarray(jp) - pos).max() > 1e-3
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5, rtol=0)
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-5, rtol=0)


def test_three_attachments_on_one_body_match_reference():
    """Body 1 holds three pins and particle 4 is pinned twice."""
    rng = np.random.default_rng(41)
    B, NP, NB = 3, 8, 3
    jspec, tspec = specs(body_spec_arrays(rng, NB, locked=False))
    particle, body = np.int32([0, 4, 4, 7]), np.int32([0, 1, 1, 1])
    local = rng.uniform(-0.05, 0.05, (4, 3)).astype(np.float32)
    pos = rng.uniform(-1, 1, (B, NB, 3)).astype(np.float32)
    quat = tilted_quats(rng, (B, NB))
    R = np.asarray(jax_xpbd.quat_apply(jnp.asarray(quat[:, body]), jnp.asarray(np.broadcast_to(local, (B, 4, 3)))))
    x = rng.uniform(-1, 1, (B, NP, 3)).astype(np.float32)
    x[:, particle] = pos[:, body] + R + rng.normal(scale=0.03, size=(B, 4, 3)).astype(np.float32)
    inv_mass = np.full(NP, 20.0, np.float32)
    jatt = jax_xpbd.BodyAttachment(jnp.asarray(particle), jnp.asarray(body), jnp.asarray(local))
    ref = jax_xpbd._solve_attachments(jnp.asarray(x), jnp.asarray(inv_mass), jnp.asarray(pos), jnp.asarray(quat), jspec, jatt)
    tatt = xpbd.BodyAttachment(torch.as_tensor(particle), torch.as_tensor(body), torch.as_tensor(local))
    made = xpbd.attachment_sum_order(tatt, NP, NB)
    assert made.body_order.tolist() == [[0, 4, 4], [1, 2, 3], [4, 4, 4]] and made.particle_order[4].tolist() == [1, 2]
    for att in (tatt, made):
        got = xpbd._solve_attachments(torch.as_tensor(x), torch.as_tensor(inv_mass), torch.as_tensor(pos),
                                      torch.as_tensor(quat), tspec, att)
        for g, r, what in zip(got, ref, ("particles", "body pos", "body quat")):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, rtol=0, err_msg=what)


# ------------------------------------------------------------ the kernel's launch plan

HEPI_MAIN_PATHS = ("cloth_hanging_multi_hepi_trpl", "rigid_insertion_multi_hepi_trpl", "rope_closing_hepi_trpl")


def main_path_calls(config, monkeypatch):
    """{(E, N, F, dtype)} of every segment sum in one collect step and one
    minibatch update of `config` at 2 envs: its widths, its graphs, its
    dtype (none of them depends on the number of envs)."""
    seen = set()
    plain = torch_common.segment_sum

    def recording(values, csr):
        seen.add((values.shape[1], csr.num_segments, values.shape[2], values.dtype))
        return plain(values, csr)

    monkeypatch.setattr(torch_common, "segment_sum", recording)
    cfg = load_config(config, overrides={"env": {"num_envs": 2, "kwargs": {"warmup_steps": 0}},
                                         "collector": {"frames_per_batch": 2},
                                         "algorithm": {"objective": {"mini_batch_size": 2, "ppo_epochs": 1}}})
    trainer = trainer_from_config(cfg, device="cpu")
    state, batch, _ = trainer._collect(trainer.init(torch.Generator().manual_seed(0)))
    trainer._update(state, batch)
    return seen


@pytest.mark.parametrize("config", HEPI_MAIN_PATHS)
def test_main_path_calls_take_the_vec16_route(config, monkeypatch):
    """Planned at the config's envs (the collect) and minibatch size (the
    update) with 16-byte aligned tensors (what torch's allocator and the
    models' contiguous messages give): the 16-byte route, at least one CTA per
    SM, within the shared memory the plan declares."""
    calls = main_path_calls(config, monkeypatch)
    cfg = load_config(config)
    assert len(calls) >= 3 and {F for _, _, F, _ in calls} == {cfg["algorithm"]["latent_dim"] * cfg["algorithm"]["num_ori"]}
    for B in (cfg["env"]["num_envs"], cfg["algorithm"]["objective"]["mini_batch_size"]):
        for E, N, F, dtype in calls:
            plan = launch_plan(B, E, N, F, dtype, True)
            assert plan.route == "vec16" and plan.grid >= H100_SMS and plan.smem <= plan.smem_limit, (B, E, N, F, plan)


@pytest.mark.parametrize("B,groups,tile,grid", [(1000, 1, 1024, 1000), (200, 4, 1024, 800), (100, 8, 1024, 800),
                                                (25, 8, 256, 800)])
def test_plan_splits_envs_until_the_grid_fills_the_card(B, groups, tile, grid):
    """bf16 rows of 1024 columns, 90 rows an env: a whole env and row per CTA
    at the rigid update's 1000 envs; at 200 and 100 envs the segments of an
    env split into 4 and 8 groups (CTAS_PER_SM CTAs per SM); at 25 envs groups
    stop at about MIN_GROUP_ROWS rows and the rows split into column tiles."""
    plan = launch_plan(B, 90, 10, 1024, torch.bfloat16, True)
    assert (plan.route, plan.groups, plan.tile, plan.grid) == ("vec16", groups, tile, grid)
    assert 90 // plan.groups >= MIN_GROUP_ROWS and plan.grid >= min(B * 90 // MIN_GROUP_ROWS, CTAS_PER_SM * H100_SMS)
    assert plan.threads == 32 * (tile * 2 // 16 // 32 + 1)  # 16 bytes a consumer thread, then the producer warp
    assert plan.stages * plan.stage_rows * tile * 2 == RING_BYTES


@pytest.mark.parametrize("F,dtype,aligned", [(1, torch.float32, True), (1, torch.bfloat16, True),
                                             (3, torch.float32, True), (12, torch.bfloat16, True),
                                             (1028, torch.bfloat16, True), (1024, torch.bfloat16, False),
                                             (64, torch.float32, False)])
def test_scalar_route_takes_what_16_byte_copies_cannot(F, dtype, aligned):
    """A row that is not a multiple of 16 bytes, or a pointer that is not
    16-byte aligned (a view with an odd storage offset, as scatter_mean's
    weights of one column): the scalar route, a thread per column of its
    tile, indices only in shared memory."""
    plan = launch_plan(4, 40, 8, F, dtype, aligned)
    assert plan.route == "scalar" and plan.groups == 1 and plan.stages == plan.stage_rows == 0
    assert plan.smem == 4 * (40 + 8 + 1)
    assert plan.threads % 32 == 0 and min(F, plan.tile) <= plan.threads <= 256
    assert plan.grid == 4 * -(-F // plan.tile)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F", [8, 64, 1024, 1028, 4096])
@pytest.mark.parametrize("E", [0, 96, 20000, 55000, 60000])
def test_ring_stays_within_the_declared_shared_memory(E, F, dtype):
    """mbarriers, the ring and the env's indices fit the limit the plan
    declares; the ring keeps RING_BYTES in flight (at least a row a stage),
    with fewer rows a stage, then fewer stages, only where one more row would
    not fit beside the indices; an env whose indices alone overflow shared
    memory raises."""
    elt = torch.empty((), dtype=dtype).element_size()
    for B, aligned in ((1, True), (1000, True), (1000, False)):
        if 4 * (E + 33) > SMEM_LIMIT:
            with pytest.raises(ValueError):
                launch_plan(B, E, 32, F, dtype, aligned)
            continue
        plan = launch_plan(B, E, 32, F, dtype, aligned)
        assert plan.smem <= plan.smem_limit == SMEM_LIMIT
        if plan.route == "vec16":
            tile_bytes = plan.tile * elt
            ring = plan.stages * plan.stage_rows * tile_bytes
            assert tile_bytes % 16 == 0 and tile_bytes <= MAX_TILE_BYTES and 2 <= plan.stages <= STAGES
            assert plan.smem == -(-16 * plan.stages // 128) * 128 + ring + 4 * (E + 33)
            assert ring <= max(RING_BYTES, STAGES * tile_bytes)
            if (plan.stages, plan.stage_rows) != (STAGES, max(1, RING_BYTES // tile_bytes // STAGES)):
                assert plan.smem + plan.stages * tile_bytes > plan.smem_limit  # one more row a stage would not fit
