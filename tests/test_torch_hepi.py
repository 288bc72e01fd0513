"""HEPi policy, DeepSets critic, graph builders and calibration in the PyTorch
port, held against the JAX package with the same (converted) parameters.

Tolerance 1e-5: both sides run the same f32 operations in the same order,
except the gather/scatter sums (one-hot matmuls in JAX, index_add in the
port) and the reductions inside LayerNorm and the fiber einsum.
"""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import test_torch_common  # noqa: F401  (pins torch to one thread per test worker)

from geometry_rl_tpu.models.calibration import calibrate as jax_calibrate
from geometry_rl_tpu.models.common import MLP as JaxMLP, gather_nodes as jax_gather, scatter_mean as jax_scatter_mean, scatter_sum as jax_scatter
from geometry_rl_tpu.models.ponita import compute_invariants as jax_invariants, polynomial_features as jax_poly
from geometry_rl_tpu.rl.obs_pipeline import obs_norm_apply, obs_norm_init, obs_norm_update
from geometry_rl_tpu.train import TrainConfig as JaxTrainConfig
from geometry_rl_tpu.train.builders import build_agent as jax_build_agent
from geometry_rl_tpu.utils.math import fibonacci_lattice as jax_fibonacci
from geometry_rl_torch.convert import params_from_flax
from geometry_rl_torch.models.calibration import calibrate
from geometry_rl_torch.models.common import MLP, gather_nodes, scatter_mean, scatter_sum
from geometry_rl_torch.models.ponita import compute_invariants, polynomial_features
from geometry_rl_torch.train.builders import build_agent
from geometry_rl_torch.utils.math import fibonacci_lattice

ATOL = 1e-5
SMALL = dict(num_envs=2, latent_dim=16, num_ori=4)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def to_torch(tree):
    return {k: torch.as_tensor(np.array(v)) for k, v in tree.items()}


@pytest.fixture(scope="module")
def agents():
    """Both agents at the small size, with the JAX agent's (post-calibrate)
    params in the port's modules, and transformed obs from a stepped state."""
    jtr = jax_build_agent(
        "cloth_hanging", "hepi", train_cfg=JaxTrainConfig(steps_per_batch=2, mini_batch_size=4),
        env_kwargs=dict(warmup_steps=0, use_pallas_solver="tiled"), **SMALL,
    )
    state = jax.jit(jtr.init)(jax.random.PRNGKey(0))
    env_state, ts = jtr.env.step(state.env_state, 0.5 * jnp.ones((2, 12)))
    norm = obs_norm_update(obs_norm_update(obs_norm_init(jtr.env.obs_spec.group_dim("scalars")), state.obs), ts.obs)
    tobs = np_tree(obs_norm_apply(norm, ts.obs))

    ttr = build_agent("cloth_hanging", "hepi", env_kwargs=dict(warmup_steps=0), device="cpu", **SMALL)
    ttr.policy.load_state_dict(params_from_flax(np_tree(state.actor_params)))
    ttr.critic.load_state_dict(params_from_flax(np_tree(state.critic_params)))
    return jtr, state, tobs, ttr


@pytest.mark.parametrize("which", ["policy", "critic"])
def test_graph_builders_match(agents, which):
    jtr, _, tobs, ttr = agents
    jb, tb = getattr(jtr, f"{which}_builder"), getattr(ttr, f"{which}_builder")
    jg_raw, jf = jb.build({k: jnp.asarray(v) for k, v in tobs.items()})
    tg, tf = tb.build(to_torch(tobs))
    # node and edge order matter (they set the feature concat and the sum order)
    assert list(tg.nodes) == list(jg_raw.nodes) and list(tg.edges) == list(jg_raw.edges)
    jg, jf = np_tree((jg_raw, jf))
    for nt, ns in jg.nodes.items():
        np.testing.assert_array_equal(tg.nodes[nt].pos.numpy(), ns.pos)
        np.testing.assert_array_equal(tg.nodes[nt].norm_pos.numpy(), ns.norm_pos)
        if ns.mask is not None:
            np.testing.assert_array_equal(tg.nodes[nt].mask.numpy(), ns.mask)
        np.testing.assert_array_equal(tf.scalars[nt].numpy(), jf.scalars[nt])
        np.testing.assert_array_equal(tf.vectors[nt].numpy(), jf.vectors[nt])
    for ek, es in jg.edges.items():
        for field in ("src", "dst", "mask"):
            np.testing.assert_array_equal(getattr(tg.edges[ek], field).numpy(), getattr(es, field))


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
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)


def test_calibrate_matches(agents):
    """Fresh (uncalibrated) JAX params, calibrated by each package, agree."""
    jtr, _, tobs, ttr = agents
    jtobs = {k: jnp.asarray(v) for k, v in tobs.items()}
    g, f = jtr.policy_builder.build(jtobs)
    raw = jax.jit(lambda key: jtr.policy.init(key, g, f))(jax.random.PRNGKey(3))
    # jitted: op by op the CPU compiles every primitive apart
    want = params_from_flax(np_tree(jax.jit(lambda p: jax_calibrate(jtr.policy, p, g, f))(raw)))
    policy = copy.deepcopy(ttr.policy)
    policy.load_state_dict(params_from_flax(np_tree(raw)))
    tg, tf = ttr.policy_builder.build(to_torch(tobs))
    calibrate(policy, tg, tf)
    got = policy.state_dict()
    scaled = [k for k in want if k.endswith(("kernel.weight", "fiber_kernel.weight"))]
    assert scaled and any(not torch.allclose(want[k], params_from_flax(np_tree(raw))[k]) for k in scaled)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=1e-5, atol=1e-6, msg=k)


def test_hepi_is_equivariant(agents):
    """Rotating positions, input vectors AND the orientation grid rotates the
    vector output (the action mean) and leaves the invariant latent (which the
    std head reads) unchanged."""
    _, _, tobs, ttr = agents
    g, f = ttr.policy_builder.build(to_torch(tobs))
    a, b = 0.7, -1.1
    Rz = torch.tensor([[math.cos(a), -math.sin(a), 0.0], [math.sin(a), math.cos(a), 0.0], [0.0, 0.0, 1.0]])
    Rx = torch.tensor([[1.0, 0.0, 0.0], [0.0, math.cos(b), -math.sin(b)], [0.0, math.sin(b), math.cos(b)]])
    R = Rz @ Rx
    rot_nodes = {nt: ns._replace(pos=ns.pos @ R.T, norm_pos=ns.norm_pos @ R.T) for nt, ns in g.nodes.items()}
    rot_feats = f._replace(vectors={nt: v @ R.T for nt, v in f.vectors.items()})
    backbone = ttr.policy.backbone
    with torch.no_grad():
        out, latent = backbone(g, f)
        out_r, latent_r = backbone(g._replace(nodes=rot_nodes), rot_feats, ori_grid=backbone.ori_grid @ R.T)
    torch.testing.assert_close(out_r, out @ R.T, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(latent_r, latent, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("n,upper", [(4, True), (16, True), (16, False)])
def test_fibonacci_lattice_matches(n, upper):
    np.testing.assert_allclose(
        fibonacci_lattice(n, upper_hemisphere=upper).numpy(), np.asarray(jax_fibonacci(n, upper_hemisphere=upper)), atol=1e-6
    )


def test_ponita_functions_match():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 2)).astype(np.float32)
    np.testing.assert_allclose(polynomial_features(torch.as_tensor(x), 2).numpy(), np.asarray(jax_poly(jnp.asarray(x), 2)), atol=1e-6)
    grid = np.array(jax_fibonacci(4, upper_hemisphere=True))  # a writable copy
    ps, pd = rng.normal(size=(2, 2, 7, 3)).astype(np.float32)
    js, jo = jax_invariants(jnp.asarray(grid), jnp.asarray(ps), jnp.asarray(pd))
    ts, to = compute_invariants(torch.as_tensor(grid), torch.as_tensor(ps), torch.as_tensor(pd))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6)


def test_gather_scatter_match():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 6, 4, 3)).astype(np.float32)
    idx = rng.integers(0, 6, size=(2, 9))
    np.testing.assert_array_equal(
        gather_nodes(torch.as_tensor(x), torch.as_tensor(idx)).numpy(), np.asarray(jax_gather(jnp.asarray(x), jnp.asarray(idx)))
    )
    m = rng.normal(size=(2, 9, 4, 3)).astype(np.float32)
    np.testing.assert_allclose(
        scatter_sum(torch.as_tensor(m), torch.as_tensor(idx), 6).numpy(),
        np.asarray(jax_scatter(jnp.asarray(m), jnp.asarray(idx), 6)), atol=1e-6,
    )
    mask = (rng.uniform(size=(2, 9)) > 0.3).astype(np.float32)
    np.testing.assert_allclose(
        scatter_mean(torch.as_tensor(m), torch.as_tensor(idx), 6, torch.as_tensor(mask)).numpy(),
        np.asarray(jax_scatter_mean(jnp.asarray(m), jnp.asarray(idx), 6, jnp.asarray(mask))), atol=1e-6,
    )


@pytest.mark.parametrize("layer_norm,final_activation", [(False, False), (True, True)])
def test_mlp_matches(layer_norm, final_activation):
    x = np.random.default_rng(2).normal(size=(3, 5)).astype(np.float32)
    jm = JaxMLP(features=(8, 8, 4), layer_norm=layer_norm, final_activation=final_activation)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tm = MLP(5, (8, 8, 4), layer_norm=layer_norm, final_activation=final_activation)
    tm.load_state_dict(params_from_flax(np_tree(params)))
    with torch.no_grad():
        got = tm(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(params, jnp.asarray(x))), atol=ATOL)
