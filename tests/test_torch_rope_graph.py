"""The rope graph builder of the PyTorch port, and HEPi and the DeepSets critic
on the rope graph, against the JAX package.

- kNN topology: equal to the JAX package's numpy kNN (`knn_edges_np`: norms
  in the layout's precision, `np.argsort` with its default kind) edge for edge
  and in order, at 20, 40 and 80 links. On the straight rest layout the 3rd
  and 4th nearest link are often exactly as far; the port's rigid kNN (f32
  squared distances, stable sort) picks other neighbours there, which the
  test also shows, so the rope builder must not reuse it.
- Graphs and features: exact (the same gathers and stacks of the same f32
  values), with and without `env_ids`.
- Policy and critic forwards with the JAX agent's params: 1e-5, as
  tests/test_torch_hepi.py holds them on the cloth graph. The rope graph's
  `target_geometry` nodes have no edge: they are encoded, and pooled by the
  critic, but no message reaches or leaves them.
- Equivariance: tests/test_models.py's test on the rope graph, at its
  tolerance (atol 1e-4, rtol 1e-3).
- The obs pipeline on the rope's groups (`scalars` is a constant zero column:
  zero variance in the running normaliser) after 3 steps: 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import test_torch_common  # noqa: F401  (pins torch to one thread per test worker)

from geometry_rl_tpu.graphs.rigid import knn_edges_np as jax_knn_edges_np
from geometry_rl_tpu.rl.obs_pipeline import obs_norm_apply, obs_norm_init, obs_norm_step as jax_obs_norm_step, obs_norm_update
from geometry_rl_tpu.train import TrainConfig as JaxTrainConfig
from geometry_rl_tpu.train.builders import build_agent as jax_build_agent
from geometry_rl_tpu.utils.math import quat_to_matrix as jax_quat_to_matrix
from geometry_rl_torch.convert import obs_norm_from_jax, params_from_flax
from geometry_rl_torch.envs import make_env
from geometry_rl_torch.graphs.rigid import knn_edges
from geometry_rl_torch.graphs.rope import RopeGraphBuilder, knn_edges_np
from geometry_rl_torch.models import HEPi
from geometry_rl_torch.rl.obs_pipeline import obs_norm_init as t_obs_norm_init, obs_norm_step
from geometry_rl_torch.train.builders import build_agent
from geometry_rl_torch.utils.math import fibonacci_lattice

ATOL = 1e-5
B, L = 4, 12
SMALL = dict(num_envs=B, latent_dim=16, num_ori=4)
ENV_KW = dict(num_links=L, rope_length=L * 0.125, warmup_steps=2)
TASKS = ["rope_closing", "rope_shaping"]


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def to_torch(tree):
    return {k: torch.as_tensor(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("links", [20, 40, 80])
def test_knn_topology_equals_the_reference_numpy_knn(links):
    env = make_env("rope_closing", num_envs=1, num_links=links, rope_length=links * 0.125, warmup_steps=0, device="cpu")
    builder = RopeGraphBuilder.from_env(env)
    x = np.arange(links, dtype=np.float32) * env.cfg.link_spacing
    layout = np.stack([x, np.zeros(links), np.zeros(links)], axis=-1)
    ref = jax_knn_edges_np(layout, links, 3)
    np.testing.assert_array_equal(knn_edges_np(layout, links, 3), ref)
    np.testing.assert_array_equal(builder.internal_src.numpy(), ref[:, 0])
    np.testing.assert_array_equal(builder.internal_dst.numpy(), ref[:, 1])
    assert builder.internal_src.shape == (3 * links,) and builder.internal_src.dtype == torch.int64
    # exact ties between the 3rd and 4th nearest link exist on this layout ...
    d = np.linalg.norm(layout[:, None] - layout[None, :], axis=-1)
    np.fill_diagonal(d, np.inf)
    ranked = np.sort(d, axis=-1)
    assert (ranked[:, 2] == ranked[:, 3]).sum() >= 4
    # ... and the rigid tasks' kNN resolves them otherwise: another graph
    other = knn_edges(layout, links, 3)
    assert (np.sort(other.reshape(links, 3, 2)[..., 0], axis=1) != np.sort(ref.reshape(links, 3, 2)[..., 0], axis=1)).any()


@pytest.fixture(scope="module", params=TASKS)
def agents(request):
    """Both agents of one rope task at a small size, the JAX agent's params
    in the port's modules, and transformed obs of a stepped state."""
    task = request.param
    jtr = jax_build_agent(task, "hepi", train_cfg=JaxTrainConfig(steps_per_batch=2, mini_batch_size=4), env_kwargs=ENV_KW, **SMALL)
    state = jax.jit(jtr.init)(jax.random.PRNGKey(0))
    action = 0.5 * jnp.ones((B, jtr.env.cfg.action_dim))
    _, ts = jax.jit(jtr.env.step)(state.env_state, action)
    norm = obs_norm_update(obs_norm_update(obs_norm_init(jtr.env.obs_spec.group_dim("scalars")), state.obs), ts.obs)
    tobs = np_tree(obs_norm_apply(norm, ts.obs))

    ttr = build_agent(task, "hepi", env_kwargs=ENV_KW, device="cpu", **SMALL)
    ttr.policy.load_state_dict(params_from_flax(np_tree(state.actor_params)))
    ttr.critic.load_state_dict(params_from_flax(np_tree(state.critic_params)))
    return jtr, state, tobs, ttr


@pytest.mark.parametrize("env_ids", [None, [3, 0, 2, 2, 1, 0]], ids=["collection", "minibatch"])
@pytest.mark.parametrize("which", ["policy", "critic"])
def test_graph_builders_match(agents, which, env_ids):
    jtr, _, tobs, ttr = agents
    if env_ids is not None:
        tobs = {k: v[np.asarray(env_ids)] for k, v in tobs.items()}
    jb, tb = getattr(jtr, f"{which}_builder"), getattr(ttr, f"{which}_builder")
    assert isinstance(tb, RopeGraphBuilder)
    assert (tb.num_scalar_features, tb.num_vector_features, tb.graph_levels) == (3, 3, ("internal", "agent", "task"))
    assert tb.dist_as_pos == jb.dist_as_pos == (which == "policy")
    jg_raw, jf = jb.build({k: jnp.asarray(v) for k, v in tobs.items()}, None if env_ids is None else jnp.asarray(env_ids, jnp.int32))
    tg, tf = tb.build(to_torch(tobs), None if env_ids is None else torch.tensor(env_ids))
    # node and edge order matter (they set the feature concat and the sum order)
    assert list(tg.nodes) == list(jg_raw.nodes) == ["links", "grippers", "target_geometry"]
    assert list(tg.edges) == list(jg_raw.edges)
    assert not any("target_geometry" in (ek[0], ek[2]) for ek in tg.edges)  # isolated nodes
    assert tg.output_node_type == jg_raw.output_node_type == "grippers"
    jg, jf = np_tree((jg_raw, jf))
    for nt, ns in jg.nodes.items():
        np.testing.assert_array_equal(tg.nodes[nt].pos.numpy(), ns.pos)
        np.testing.assert_array_equal(tg.nodes[nt].norm_pos.numpy(), ns.norm_pos)
        assert tg.nodes[nt].mask is None and ns.mask is None
        np.testing.assert_array_equal(tf.scalars[nt].numpy(), jf.scalars[nt])
        np.testing.assert_array_equal(tf.vectors[nt].numpy(), jf.vectors[nt])
    for ek, es in jg.edges.items():
        for field in ("src", "dst", "mask"):
            np.testing.assert_array_equal(getattr(tg.edges[ek], field).numpy(), getattr(es, field), err_msg=f"{ek} {field}")


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
        # the critic pools the isolated target nodes too: moving them moves the value
        moved = dict(to_torch(tobs))
        spec = ttr.env.obs_spec
        start = sum(spec.dims["position_vectors"][:2])
        npv = moved["norm_position_vectors"].clone()
        npv[:, start:] += 0.5
        moved["norm_position_vectors"] = npv
        assert (ttr._value(moved) - tv).abs().max() > 1e-4
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=1e-5)


def test_hepi_is_equivariant_on_the_rope_graph(agents):
    """tests/test_models.py's equivariance test on the rope graph: a random
    rotation R of positions, input vectors and the full-sphere orientation
    grid rotates the vector output by R and leaves the invariant latent."""
    _, _, tobs, ttr = agents
    g, f = ttr.policy_builder.build(to_torch(tobs))
    torch.manual_seed(0)  # the model's init
    model = HEPi(3, 3, latent_dim=32, hidden_dim=32, output_dim=2, output_dim_vec=2, num_ori=12, only_upper_hemisphere=False)
    grid = fibonacci_lattice(12)
    q = np.random.default_rng(1).normal(size=4).astype(np.float32)
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


def test_obs_pipeline_on_the_rope_groups_matches(agents):
    """3 steps of normaliser update + transform on both sides from the same
    observations: `scalars` (a constant zero column) and `infos` (a
    constant) see zero variance."""
    jtr, state, _, ttr = agents
    j_norm = obs_norm_init(jtr.env.obs_spec.group_dim("scalars"))
    t_norm = t_obs_norm_init(ttr.env.obs_spec.group_dim("scalars"))
    js, j_obs = state.env_state, state.obs
    rng = np.random.default_rng(2)
    for _ in range(3):
        j_norm, jt = jax_obs_norm_step(j_norm, j_obs, update=True)
        t_norm, tt = obs_norm_step(t_norm, to_torch(np_tree(j_obs)), update=True)
        assert sorted(tt) == sorted(jt)
        for k, v in jt.items():
            np.testing.assert_allclose(tt[k].numpy(), np.asarray(v), atol=ATOL, rtol=1e-5, err_msg=k)
            assert np.isfinite(tt[k].numpy()).all(), k
        js, ts = jtr.env.step(js, jnp.asarray(rng.uniform(-1, 1, (B, 6)).astype(np.float32)))
        j_obs = ts.obs
    conv = obs_norm_from_jax(np_tree(j_norm))  # the running statistics themselves
    for a, b in zip(t_norm, conv):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x.numpy(), y.numpy(), atol=ATOL, rtol=1e-5)


NOISE_STD = 0.05
NOISE_DRAWS = 48  # x 4 samples x 2 grippers x 9 values: >= 3,456 values per node type
NOISE_STD_RTOL = 0.05  # the sample std of >= 3,456 normals is within ~1.2% (1 sigma)


def test_training_noise_has_the_reference_law(agents):
    """Per node type, the noise the rope builder adds to the vector features
    is zero-mean with std `training_noise_std`, in the port and in the
    reference's builder alike (their generators differ, so the draws cannot
    match); scalars and the graph stay clean, and no generator means no noise."""
    jtr, _, tobs, ttr = agents
    jb = dataclasses.replace(jtr.policy_builder, training_noise=True, training_noise_std=NOISE_STD)
    tobs_j = {k: jnp.asarray(v) for k, v in tobs.items()}
    build_j = jax.jit(lambda key: jb.build(tobs_j, None, noise_key=key)[1].vectors)
    clean_j = jb.build(tobs_j)[1].vectors
    tb = ttr.policy_builder
    tb.training_noise, tb.training_noise_std = True, NOISE_STD
    try:
        graph_c, clean_t = tb.build(to_torch(tobs))
        gen = torch.Generator().manual_seed(5)
        diffs_j, diffs_t = {nt: [] for nt in clean_j}, {nt: [] for nt in clean_j}
        for d in range(NOISE_DRAWS):
            vj = build_j(jax.random.PRNGKey(d))
            graph_n, feats = tb.build(to_torch(tobs), None, gen)
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
        assert dt.size == dj.size >= 3456, (nt, dt.size)
        for what, d in (("port", dt), ("reference", dj)):
            assert abs(d.std() / NOISE_STD - 1.0) <= NOISE_STD_RTOL, (what, nt, d.std())
            assert abs(d.mean()) <= 4 * NOISE_STD / np.sqrt(d.size), (what, nt, d.mean())
