"""The rigid graph builder of the PyTorch port, and HEPi and the DeepSets critic
on the rigid graph, against the JAX package.

- kNN topology: exactly the native C++ kNN's (src, dst and mask) on the
  three shape sets the rigid tasks use.
- Graphs and features: exact (the same gathers and stacks of the same f32
  values), for the collection layout and for shuffled minibatch env ids.
- Policy and critic forwards with the JAX agent's params: 1e-5, as
  tests/test_torch_hepi.py holds them on the cloth graph.
- Equivariance: tests/test_models.py's exact test (rotate positions, input
  vectors and the orientation grid; the vector output rotates, the latent
  stays) on the rigid graph, at its tolerance (atol 1e-4, rtol 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import test_torch_common  # noqa: F401  (pins torch to one thread per test worker)

from geometry_rl_tpu import native
from geometry_rl_tpu.rl.obs_pipeline import obs_norm_apply, obs_norm_init, obs_norm_update
from geometry_rl_tpu.sim.shapes import build_shape_set as jax_build_shape_set
from geometry_rl_tpu.train import TrainConfig as JaxTrainConfig
from geometry_rl_tpu.train.builders import build_agent as jax_build_agent
from geometry_rl_tpu.utils.math import quat_to_matrix as jax_quat_to_matrix
from geometry_rl_torch.convert import params_from_flax
from geometry_rl_torch.graphs.rigid import RigidGraphBuilder, knn_graph_batch
from geometry_rl_torch.models import HEPi
from geometry_rl_torch.sim.shapes import PUSHING_SHAPE_NAMES, SHAPE_NAMES
from geometry_rl_torch.train.builders import build_agent
from geometry_rl_torch.utils.math import fibonacci_lattice

ATOL = 1e-5
SMALL = dict(num_envs=8, latent_dim=16, num_ori=4)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def to_torch(tree):
    return {k: torch.as_tensor(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("names", [SHAPE_NAMES, PUSHING_SHAPE_NAMES, ("L",)], ids=["insertion", "pushing", "sliding"])
def test_knn_topology_equals_native(names):
    """f32 squared distances, ties to the lower index: the native kNN's
    neighbour sets in its order, where an f64 norm with an unstable sort
    would pick other neighbours on ties."""
    assert native.HAVE_NATIVE
    ss = jax_build_shape_set(names)
    pts, counts = np.array(ss.points), np.array(ss.num_points)
    got = knn_graph_batch(pts, counts, 3)
    ref = native.knn_graph_batch(pts, counts, 3)
    for g, r, what in zip(got, ref, ("src", "dst", "mask")):
        assert g.dtype == r.dtype, what
        np.testing.assert_array_equal(g, r, err_msg=what)


@pytest.fixture(scope="module")
def agents():
    """Both rigid_insertion agents at a small size (8 envs: each shape once),
    the JAX agent's params in the port's modules, and transformed obs of a
    stepped state."""
    jtr = jax_build_agent("rigid_insertion", "hepi", train_cfg=JaxTrainConfig(steps_per_batch=2, mini_batch_size=8),
                          env_kwargs=dict(warmup_steps=0), **SMALL)
    state = jax.jit(jtr.init)(jax.random.PRNGKey(0))
    action = 0.5 * jnp.ones((8, jtr.env.cfg.action_dim))
    _, ts = jax.jit(jtr.env.step)(state.env_state, action)
    norm = obs_norm_update(obs_norm_update(obs_norm_init(jtr.env.obs_spec.group_dim("scalars")), state.obs), ts.obs)
    tobs = np_tree(obs_norm_apply(norm, ts.obs))

    ttr = build_agent("rigid_insertion", "hepi", env_kwargs=dict(warmup_steps=0), device="cpu", **SMALL)
    ttr.policy.load_state_dict(params_from_flax(np_tree(state.actor_params)))
    ttr.critic.load_state_dict(params_from_flax(np_tree(state.critic_params)))
    return jtr, state, tobs, ttr


@pytest.mark.parametrize("env_ids", [None, [5, 0, 7, 7, 2, 1, 6, 3, 4, 0]], ids=["collection", "minibatch"])
@pytest.mark.parametrize("which", ["policy", "critic"])
def test_graph_builders_match(agents, which, env_ids):
    jtr, _, tobs, ttr = agents
    if env_ids is not None:  # a minibatch: samples of any env, in any order
        tobs = {k: v[np.arange(len(env_ids)) % 8] for k, v in tobs.items()}
    jb, tb = getattr(jtr, f"{which}_builder"), getattr(ttr, f"{which}_builder")
    assert isinstance(tb, RigidGraphBuilder)
    assert (tb.num_scalar_features, tb.num_vector_features) == (3, 4)
    jg_raw, jf = jb.build({k: jnp.asarray(v) for k, v in tobs.items()},
                          None if env_ids is None else jnp.asarray(env_ids, jnp.int32))
    tg, tf = tb.build(to_torch(tobs), None if env_ids is None else torch.tensor(env_ids))
    # node and edge order matter (they set the feature concat and the sum order)
    assert list(tg.nodes) == list(jg_raw.nodes) and list(tg.edges) == list(jg_raw.edges)
    assert tg.output_node_type == jg_raw.output_node_type
    jg, jf = np_tree((jg_raw, jf))
    for nt, ns in jg.nodes.items():
        np.testing.assert_array_equal(tg.nodes[nt].pos.numpy(), ns.pos)
        np.testing.assert_array_equal(tg.nodes[nt].norm_pos.numpy(), ns.norm_pos)
        assert (tg.nodes[nt].mask is None) == (ns.mask is None)
        if ns.mask is not None:
            np.testing.assert_array_equal(tg.nodes[nt].mask.numpy(), ns.mask)
        np.testing.assert_array_equal(tf.scalars[nt].numpy(), jf.scalars[nt])
        np.testing.assert_array_equal(tf.vectors[nt].numpy(), jf.vectors[nt])
    for ek, es in jg.edges.items():
        for field in ("src", "dst", "mask"):
            np.testing.assert_array_equal(getattr(tg.edges[ek], field).numpy(), getattr(es, field), err_msg=f"{ek} {field}")


@pytest.mark.parametrize("task", ["rigid_insertion_two_agents", "rigid_sliding"])
def test_other_rigid_builders_match(task):
    """Two grippers (agent edges) and the sliding task's observation groups
    (no object velocities): the builders on the reset observation."""
    jtr = jax_build_agent(task, "hepi", train_cfg=JaxTrainConfig(steps_per_batch=2, mini_batch_size=4),
                          env_kwargs=dict(warmup_steps=0), num_envs=4, latent_dim=8, num_ori=4)
    obs = jtr.env.observe(jtr.env.reset(jax.random.PRNGKey(1)))
    tobs = np_tree(obs_norm_apply(obs_norm_update(obs_norm_init(jtr.env.obs_spec.group_dim("scalars")), obs), obs))
    ttr = build_agent(task, "hepi", env_kwargs=dict(warmup_steps=0), device="cpu", num_envs=4, latent_dim=8, num_ori=4)
    for which in ("policy", "critic"):
        jg_raw, jf = getattr(jtr, f"{which}_builder").build({k: jnp.asarray(v) for k, v in tobs.items()})
        tg, tf = getattr(ttr, f"{which}_builder").build(to_torch(tobs))
        assert list(tg.edges) == list(jg_raw.edges)
        jg, jf = np_tree((jg_raw, jf))
        for ek, es in jg.edges.items():
            np.testing.assert_array_equal(tg.edges[ek].src.numpy(), es.src)
            np.testing.assert_array_equal(tg.edges[ek].mask.numpy(), es.mask)
        for nt in jf.vectors:
            np.testing.assert_array_equal(tf.vectors[nt].numpy(), jf.vectors[nt])


def test_policy_forward_matches(agents):
    jtr, state, tobs, ttr = agents
    jd = jax.jit(jtr._policy_dist)(state.actor_params, {k: jnp.asarray(v) for k, v in tobs.items()})
    with torch.no_grad():
        td = ttr._policy_dist(to_torch(tobs))
    assert np.abs(np.asarray(jd.mean)).max() > 1e-2  # a non-trivial output
    np.testing.assert_allclose(td.mean.numpy(), np.asarray(jd.mean), atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(td.std.numpy(), np.asarray(jd.std), atol=ATOL)


def test_critic_forward_matches(agents):
    jtr, state, tobs, ttr = agents
    jv = jax.jit(jtr._value)(state.critic_params, {k: jnp.asarray(v) for k, v in tobs.items()})
    with torch.no_grad():
        tv = ttr._value(to_torch(tobs))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=1e-5)


def test_hepi_is_equivariant_on_the_rigid_graph(agents):
    """tests/test_models.py's equivariance test on the rigid graph: a random
    rotation R (from a seeded quaternion) of positions, input vectors AND the
    full-sphere orientation grid rotates the vector output by R and leaves
    the invariant latent unchanged."""
    _, _, tobs, ttr = agents
    g, f = ttr.policy_builder.build(to_torch(tobs))
    torch.manual_seed(0)  # the model's init
    model = HEPi(3, 4, latent_dim=32, hidden_dim=32, output_dim=2, output_dim_vec=2, num_ori=12, only_upper_hemisphere=False)
    grid = fibonacci_lattice(12)
    rng = np.random.default_rng(1)
    q = rng.normal(size=4).astype(np.float32)
    q /= np.linalg.norm(q)
    R = torch.as_tensor(np.array(jax_quat_to_matrix(jnp.asarray(q))))
    rot_nodes = {nt: ns._replace(pos=ns.pos @ R.T, norm_pos=ns.norm_pos @ R.T) for nt, ns in g.nodes.items()}
    rot_feats = f._replace(vectors={nt: v @ R.T for nt, v in f.vectors.items()})
    with torch.no_grad():
        out, latent = model(g, f, ori_grid=grid)
        out_r, latent_r = model(g._replace(nodes=rot_nodes), rot_feats, ori_grid=grid @ R.T)
    assert out.abs().max() > 1e-3
    np.testing.assert_allclose(out_r.numpy(), (out @ R.T).numpy(), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(latent_r.numpy(), latent.numpy(), atol=1e-4, rtol=1e-3)


NOISE_STD = 0.05
NOISE_DRAWS = 32  # x 8 samples: >= 3,072 values per node type (the gripper's 12 a sample)
NOISE_STD_RTOL = 0.05  # the sample std of >= 3,072 normals is within ~1.3% (1 sigma)


@pytest.mark.parametrize("part", ["policy", "critic"])
def test_training_noise_has_the_reference_law(agents, part):
    """Per node type, the noise the rigid builder adds to the vector features
    is zero-mean with std `training_noise_std`, in the port and in the
    reference's builder alike (their generators differ, so the draws cannot
    match); scalars and the graph stay clean, and no generator means no
    noise."""
    import dataclasses

    jtr, _, tobs, ttr = agents
    env_ids = np.arange(8)[::-1].copy()
    jb = dataclasses.replace(getattr(jtr, f"{part}_builder"), training_noise=True, training_noise_std=NOISE_STD)
    tobs_j = {k: jnp.asarray(v) for k, v in tobs.items()}
    build_j = jax.jit(lambda key: jb.build(tobs_j, jnp.asarray(env_ids), noise_key=key)[1].vectors)
    clean_j = jb.build(tobs_j, jnp.asarray(env_ids))[1].vectors
    tb = getattr(ttr, f"{part}_builder")
    tb.training_noise, tb.training_noise_std = True, NOISE_STD
    try:
        graph_c, clean_t = tb.build(to_torch(tobs), torch.as_tensor(env_ids))
        gen = torch.Generator().manual_seed(5)
        diffs_j = {nt: [] for nt in clean_j}
        diffs_t = {nt: [] for nt in clean_j}
        for d in range(NOISE_DRAWS):
            vj = build_j(jax.random.PRNGKey(d))
            graph_n, feats = tb.build(to_torch(tobs), torch.as_tensor(env_ids), gen)
            assert all(torch.equal(feats.scalars[nt], clean_t.scalars[nt]) for nt in clean_t.scalars)
            assert all(torch.equal(graph_n.nodes[nt].pos, graph_c.nodes[nt].pos) for nt in graph_c.nodes)
            for nt in clean_j:
                diffs_j[nt].append(np.asarray(vj[nt] - clean_j[nt]).reshape(-1))
                diffs_t[nt].append((feats.vectors[nt] - clean_t.vectors[nt]).reshape(-1).numpy())
    finally:
        tb.training_noise, tb.training_noise_std = False, 1e-2
    assert sorted(clean_t.vectors) == sorted(clean_j)
    for nt in clean_j:
        np.testing.assert_array_equal(clean_t.vectors[nt].numpy(), np.asarray(clean_j[nt]))
        dj, dt = np.concatenate(diffs_j[nt]), np.concatenate(diffs_t[nt])
        assert dt.size == dj.size >= 3072, (nt, dt.size)
        for what, d in (("port", dt), ("reference", dj)):
            assert abs(d.std() / NOISE_STD - 1.0) <= NOISE_STD_RTOL, (what, nt, d.std())
            assert abs(d.mean()) <= 4 * NOISE_STD / np.sqrt(d.size), (what, nt, d.mean())
