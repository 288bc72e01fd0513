"""The port's baseline models (EMPN, Transformer, GCN, MeshGraphNet, flat
MLP) and the optional branches of HEPi, the PONITA convs and the policy head,
against the JAX package's modules.

Inputs come from numpy seeds; the Flax params go through `params_from_flax`
and are loaded strictly, so a missing or misnamed parameter fails the load.
All forwards run in f32 on the CPU.

Tolerances, relative to each output's largest reference entry:
- 1e-5 for the message-passing models, the MLPs and the convs: a handful of
  f32 matmuls and sums in another order than XLA's (~1e-7 each);
- 2e-5 for the transformer: two softmax + LayerNorm chains on top of that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometry_rl_tpu import models as jm
from geometry_rl_tpu.graphs import types as jtypes
from geometry_rl_tpu.models import ponita as jponita
from geometry_rl_tpu.models.calibration import calibrate as jax_calibrate
from geometry_rl_tpu.utils import math as jmath
from geometry_rl_torch import models as tm
from geometry_rl_torch.convert import params_from_flax
from geometry_rl_torch.graphs import types as ttypes
from geometry_rl_torch.models import ponita as tponita
from geometry_rl_torch.models.common import init_params
from geometry_rl_torch.train.builders import EQUIVARIANT_MODELS, FLAT_MODELS
from test_torch_common import frozen, np_tree, port_agent, reference_agent, reference_forward, reference_tobs

RTOL = {"transformer": 2e-5}
B, N_OBJ = 3, 8
S, V = 3, 4  # scalar and vector feature counts of the toy graph
IN_DIM = S + 3 * V


def assert_close(got, ref, rtol, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = np.abs(ref).max()
    assert scale > 1e-4, (what, "a trivial reference output")
    assert np.abs(got - ref).max() <= rtol * scale, (what, np.abs(got - ref).max(), scale)


# ------------------------------------------------------------ a toy graph

def toy_arrays(seed, num_grippers=1, padded=2):
    """Rigid-task-like graph as numpy arrays: object_geometry (its last
    `padded` nodes and their edges masked out) + grippers."""
    rng = np.random.default_rng(seed)
    G = num_grippers
    node_mask = np.ones((B, N_OBJ), np.float32)
    node_mask[:, N_OBJ - padded:] = 0.0
    ring = np.tile(np.arange(N_OBJ), (B, 1))
    pairs = [(i, j) for i in range(G) for j in range(G) if i != j]
    edges = {
        ("object_geometry", "internal", "object_geometry"): (ring, (ring + 1) % N_OBJ, node_mask * np.roll(node_mask, -1, 1)),
        ("object_geometry", "task", "grippers"): (np.tile(np.arange(N_OBJ), (B, G)), np.repeat(np.arange(G), N_OBJ)[None].repeat(B, 0),
                                                  np.tile(node_mask, (1, G))),
    }
    if pairs:
        edges[("grippers", "agent", "grippers")] = (
            np.tile([p[0] for p in pairs], (B, 1)), np.tile([p[1] for p in pairs], (B, 1)), np.ones((B, len(pairs)), np.float32))
    pos = {"object_geometry": rng.normal(size=(B, N_OBJ, 3)).astype(np.float32),
           "grippers": rng.normal(size=(B, G, 3)).astype(np.float32)}
    scalars = {nt: np.tile(np.eye(S, dtype=np.float32)[i], p.shape[:2] + (1,)) for i, (nt, p) in enumerate(pos.items())}
    vectors = {nt: rng.normal(size=p.shape[:2] + (V, 3)).astype(np.float32) for nt, p in pos.items()}
    return dict(pos=pos, mask={"object_geometry": node_mask, "grippers": None}, edges=edges, scalars=scalars, vectors=vectors)


def as_graph(arr, types, tensor, index):
    nodes = {nt: types.NodeSet(pos=tensor(p), norm_pos=tensor(p * 0.5), mask=None if arr["mask"][nt] is None else tensor(arr["mask"][nt]))
             for nt, p in arr["pos"].items()}
    edges = {ek: types.EdgeSet(src=index(s), dst=index(d), mask=tensor(m)) for ek, (s, d, m) in arr["edges"].items()}
    feats = types.GraphFeatures(scalars={k: tensor(v) for k, v in arr["scalars"].items()},
                                vectors={k: tensor(v) for k, v in arr["vectors"].items()})
    return types.HeteroGraph(nodes=nodes, edges=edges, output_node_type="grippers"), feats


def both_graphs(arr):
    return (as_graph(arr, jtypes, jnp.asarray, lambda a: jnp.asarray(a, jnp.int32)),
            as_graph(arr, ttypes, torch.as_tensor, lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64)))


# -------------------------------------- module by module, on the toy graph

W = 16  # width
SHAPE = dict(in_scalars=S, in_vectors=V)
MODULES = {
    # name: (flax module, port module, rtol)
    "ponita_gcn": (lambda: jm.PonitaGCN(latent_dim=W, hidden_dim=W, output_dim=2, output_dim_vec=2, num_ori=4),
                   lambda: tm.PonitaGCN(**SHAPE, latent_dim=W, hidden_dim=W, output_dim=2, output_dim_vec=2, num_ori=4), 1e-5),
    "transformer": (lambda: jm.TransformerVanilla(hidden_dim=W, output_dim=W),
                    lambda: tm.TransformerVanilla(IN_DIM, hidden_dim=W, output_dim=W), 2e-5),
    "transformer_concat_global": (lambda: jm.TransformerVanilla(hidden_dim=W, output_dim=5, num_heads=4, concat_global=True),
                                  lambda: tm.TransformerVanilla(IN_DIM, hidden_dim=W, output_dim=5, num_heads=4, concat_global=True), 2e-5),
    "gcn": (lambda: jm.GCN(hidden_dim=W, output_dim=W), lambda: tm.GCN(IN_DIM, 2, hidden_dim=W, output_dim=W), 1e-5),
    "gcn_concat_global": (lambda: jm.GCN(hidden_dim=W, output_dim=5, num_layers=3, concat_global=True),
                          lambda: tm.GCN(IN_DIM, 2, hidden_dim=W, output_dim=5, num_layers=3, concat_global=True), 1e-5),
    "meshgraphnet": (lambda: jm.MeshGraphNet(hidden_dim=W, output_dim=W),
                     lambda: tm.MeshGraphNet(IN_DIM, 2, hidden_dim=W, output_dim=W), 1e-5),
    "hepi_concat_global": (lambda: jm.HEPi(latent_dim=W, hidden_dim=W, output_dim=2, output_dim_vec=2, num_ori=4, concat_global=True),
                           lambda: tm.HEPi(**SHAPE, latent_dim=W, hidden_dim=W, output_dim=2, output_dim_vec=2, num_ori=4,
                                           concat_global=True, graph_levels=("internal", "task")), 1e-5),
}


@pytest.mark.parametrize("name", list(MODULES))
def test_backbone_forward_matches_reference(name):
    """(out, latent) of each backbone on a graph with padded nodes."""
    flax_fn, port_fn, rtol = MODULES[name]
    (jg, jf), (tg, tf) = both_graphs(toy_arrays(0))
    jmod, tmod = flax_fn(), port_fn()
    # jitted over the params alone: a graph holds a string, which jit takes as no argument
    params = jax.jit(lambda key: jmod.init(key, jg, jf))(jax.random.PRNGKey(0))
    tmod.load_state_dict(params_from_flax(np_tree(params)))
    jout = jax.jit(lambda p: jmod.apply(p, jg, jf))(params)
    with torch.no_grad():
        tout = tmod(tg, tf)
    for what, t, j in zip(("out", "latent"), tout, jout):
        assert_close(t.numpy(), j, rtol, f"{name}.{what}")
    if name == "hepi_concat_global":
        assert tout[1].shape[-1] == 2 * W  # the global mean doubles the latent


@pytest.mark.parametrize("name", ["fiber_conv_full", "fiber_conv_depthwise_no_bias", "convnext_layer_scale"])
def test_conv_variants_match_reference(name):
    """`FiberBundleConv(depthwise=False)` (the fiber kernel is
    Dense(channels * in) reshaped [O, P, out, in], divided by O), its
    `use_bias=False`, and `SeparableFiberBundleConvNext` with a layer scale."""
    rng = np.random.default_rng(4)
    C, O, A, E, N = 6, 4, 5, 12, 7
    f32 = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    x_src, x_dst, kb, fb = f32(B, N, O, C), f32(B, N, O, C), f32(B, E, O, A), f32(O, O, A)
    src, dst = rng.integers(0, N, (B, E)), rng.integers(0, N, (B, E))
    mask = (rng.random((B, E)) > 0.3).astype(np.float32)
    if name == "convnext_layer_scale":
        jconv, tconv = jponita.SeparableFiberBundleConvNext(C, layer_scale_init=0.5), tponita.SeparableFiberBundleConvNext(C, A, layer_scale_init=0.5)
        nodes = (x_dst,)
    else:
        kw = dict(depthwise=False) if name == "fiber_conv_full" else dict(use_bias=False)
        jconv, tconv = jponita.FiberBundleConv(C, **kw), tponita.FiberBundleConv(C, A, **kw)
        nodes = (x_src, x_dst)
    jargs = [jnp.asarray(a) for a in nodes] + [jnp.asarray(src, jnp.int32), jnp.asarray(dst, jnp.int32), jnp.asarray(mask), jnp.asarray(kb), jnp.asarray(fb)]
    targs = [torch.as_tensor(a) for a in nodes] + [torch.as_tensor(src), torch.as_tensor(dst), torch.as_tensor(mask), torch.as_tensor(kb), torch.as_tensor(fb)]
    params = jax.jit(jconv.init)(jax.random.PRNGKey(1), *jargs)
    flat = np_tree(params["params"])
    # non-zero bias and a non-trivial kernel scale, so every term counts
    if "bias" in flat:
        flat["bias"] = f32(C)
    tconv.load_state_dict(params_from_flax(flat))
    if name == "fiber_conv_full":
        assert tconv.fiber_kernel.weight.shape == (C * C, A)
    if name == "fiber_conv_depthwise_no_bias":
        assert "bias" not in tconv.state_dict()
    if name == "convnext_layer_scale":
        assert torch.equal(tconv.layer_scale, torch.full((C,), 0.5))
    ref = jax.jit(jconv.apply)({"params": jax.tree_util.tree_map(jnp.asarray, flat)}, *jargs)
    with torch.no_grad():
        got = tconv(*targs)
    assert_close(got.numpy(), ref, 1e-5, name)
    # a fresh draw resets the layer scale to its constant
    if name == "convnext_layer_scale":
        with torch.no_grad():
            tconv.layer_scale.mul_(3.0)
        init_params(tconv, torch.Generator().manual_seed(0))
        assert torch.equal(tconv.layer_scale, torch.full((C,), 0.5))


def test_mlp_value_net_matches_reference():
    obs = np.random.default_rng(5).normal(size=(B, 10)).astype(np.float32)
    jmod, tmod = jm.MLPValueNet(hidden_dims=(32, 16)), tm.MLPValueNet(10, hidden_dims=(32, 16))
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(obs))
    tmod.load_state_dict(params_from_flax(np_tree(params)))
    with torch.no_grad():
        assert_close(tmod(torch.as_tensor(obs)).numpy(), jmod.apply(params, jnp.asarray(obs)), 1e-5, "MLPValueNet")


# --------------------------------- the policy and critic the builders make

SMALL = dict(num_envs=2, latent_dim=8, num_ori=4)


@pytest.mark.parametrize("task", ["rigid_insertion", "cloth_hanging"])
@pytest.mark.parametrize("model", ["empn", "transformer", "gcn", "meshgraphnet", "mlp"])
def test_built_policy_and_critic_match_reference(model, task):
    """`build_agent(task, model)` of both packages on the task's own graph:
    the action distribution and the value of the initial observation, with
    the calibrated Flax params copied."""
    akw = frozen(env_kwargs=dict(warmup_steps=0), **SMALL)
    jtr, js = reference_agent(task, model, akw)
    ttr, _ = port_agent(task, model, js, akw)
    assert (ttr.policy.post_fc if model not in FLAT_MODELS else True) == (model not in EQUIVARIANT_MODELS)
    jt, tt = reference_tobs(js)
    jdist, jvalue = reference_forward(jtr, js.actor_params, js.critic_params, jt)
    with torch.no_grad():
        tdist, tvalue = ttr._policy_dist(tt), ttr._value(tt)
    rtol = RTOL.get(model, 1e-5)
    assert_close(tdist.mean.numpy(), jdist.mean, rtol, "mean")
    assert_close(tdist.std.numpy(), jdist.std, rtol, "std")
    assert_close(tvalue.numpy(), jvalue, rtol, "value")


def test_hepi_default_state_dict_is_unchanged():
    """The optional HEPi / policy branches are off by default: the default
    policy holds exactly the reference's parameters."""
    akw = frozen(env_kwargs=dict(warmup_steps=0), **SMALL)
    _, js = reference_agent("rigid_insertion", "hepi", akw)
    ttr, _ = port_agent("rigid_insertion", "hepi", js, akw)
    assert sorted(ttr.policy.state_dict()) == sorted(params_from_flax(np_tree(js.actor_params)))
    assert not any("layer_scale" in k or "cls_token" in k or "mean" in k for k in ttr.policy.state_dict())


# ------------------------------------------------------------- properties

def test_ponita_gcn_equivariance():
    """Rotating positions, vector features and the grid rotates PonitaGCN's
    vector output exactly and leaves its invariant latent unchanged; the
    same holds in the reference, whose outputs the port's equal."""
    arr = toy_arrays(1, padded=0)
    rng = np.random.default_rng(2)
    q = rng.normal(size=4).astype(np.float32)
    R = np.asarray(jmath.quat_to_matrix(jnp.asarray(q / np.linalg.norm(q))))
    rot = dict(arr, pos={k: v @ R.T for k, v in arr["pos"].items()}, vectors={k: v @ R.T for k, v in arr["vectors"].items()})
    (jg, jf), (tg, tf) = both_graphs(arr)
    (_, _), (tg_r, tf_r) = both_graphs(rot)
    # as_graph derives norm_pos from pos, so it rotates with it
    grid = np.asarray(jmath.fibonacci_lattice(12))
    jmod = jm.PonitaGCN(latent_dim=W, hidden_dim=W, output_dim=2, output_dim_vec=2, num_ori=12, only_upper_hemisphere=False)
    tmod = tm.PonitaGCN(**SHAPE, latent_dim=W, hidden_dim=W, output_dim=2, output_dim_vec=2, num_ori=12, only_upper_hemisphere=False)
    params = jax.jit(lambda key: jmod.init(key, jg, jf, ori_grid=jnp.asarray(grid)))(jax.random.PRNGKey(0))
    tmod.load_state_dict(params_from_flax(np_tree(params)))
    np.testing.assert_allclose(tmod.ori_grid.numpy(), grid, atol=1e-6)
    with torch.no_grad():
        out, latent = tmod(tg, tf, ori_grid=torch.as_tensor(grid))
        out_r, latent_r = tmod(tg_r, tf_r, ori_grid=torch.as_tensor(grid @ R.T))
    np.testing.assert_allclose(out_r.numpy(), out.numpy() @ R.T, atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(latent_r.numpy(), latent.numpy(), atol=1e-4, rtol=1e-3)
    jout, _ = jax.jit(lambda p: jmod.apply(p, jg, jf, ori_grid=jnp.asarray(grid)))(params)
    assert_close(out.numpy(), jout, 1e-5, "out")


@pytest.mark.parametrize("concat_global", [False, True])
def test_transformer_masks_padded_nodes(concat_global):
    """A padded node is no key of the attention: its features change nothing
    at the output nodes (in the reference, and so in the port)."""
    arr = toy_arrays(3, padded=3)
    tmod = tm.TransformerVanilla(IN_DIM, hidden_dim=W, output_dim=W, concat_global=concat_global)
    init_params(tmod, torch.Generator().manual_seed(0))
    other = dict(arr, vectors={k: v.copy() for k, v in arr["vectors"].items()})
    other["vectors"]["object_geometry"][:, N_OBJ - 3:] += 100.0
    (_, _), (tg, tf) = both_graphs(arr)
    (_, _), (tg2, tf2) = both_graphs(other)
    with torch.no_grad():
        a, b = tmod(tg, tf), tmod(tg2, tf2)
        real = dict(other, vectors={k: v.copy() for k, v in arr["vectors"].items()})
        real["vectors"]["object_geometry"][:, 0] += 100.0
        c = tmod(*both_graphs(real)[1])
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert (a[0] - c[0]).abs().max() > 1e-3  # a real node does count
    if concat_global:
        assert tmod.cls_token.abs().max() > 0  # drawn by init_params, normal(1.0)


@pytest.mark.parametrize("model", ["empn", "transformer", "mlp"])
def test_calibrate_matches_reference(model):
    """From the same uncalibrated params, the port's `calibrate` gives the
    reference's kernels for SeparableFiberBundleConvNext (EMPN's std_in is
    the std over the merged nodes, no Bessel correction) and leaves a
    conv-free model as it is."""
    akw = frozen(env_kwargs=dict(warmup_steps=0), **SMALL)
    jtr, js = reference_agent("rigid_insertion", model, akw)
    ttr, _ = port_agent("rigid_insertion", model, js, akw)
    jt, tt = reference_tobs(js)
    g, f = jtr.policy_builder.build(jt)
    raw = jax.jit(lambda key: jtr.policy.init(key, g, f))(jax.random.PRNGKey(7))
    raw = {"params": raw["params"]}
    # jitted: op by op the CPU compiles every primitive apart
    ref = params_from_flax(np_tree(jax.jit(lambda p: jax_calibrate(jtr.policy, p, g, f))(raw)))
    before = params_from_flax(np_tree(raw))
    ttr.policy.load_state_dict(before)
    tm.calibrate(ttr.policy, *ttr.policy_builder.build(tt))
    got = ttr.policy.state_dict()
    changed = [k for k in got if not torch.equal(got[k], before[k])]
    if model == "empn":
        assert sorted(changed) == sorted(f"backbone.interaction_{i}.{k}.weight" for i in range(2) for k in ("kernel", "fiber_kernel"))
        for k in changed:
            np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=1e-4, err_msg=k)
            assert (ref[k] - before[k]).abs().max() > 1e-3 * before[k].abs().max()
    else:
        assert changed == [] and all(torch.equal(ref[k], before[k]) for k in ref)


HEADS = {
    "non_contextual_std": dict(contextual_std=False, post_fc=True),
    "per_actuator_heads": dict(per_actuator_heads=True, post_fc=True),
    "per_actuator_heads_non_contextual_std": dict(per_actuator_heads=True, contextual_std=False, post_fc=True),
    "tanh_mean": dict(use_tanh_mean=True, post_fc=False),
}


@pytest.mark.parametrize("name", list(HEADS))
def test_policy_head_variants_match_reference(name):
    """`contextual_std=False` (a bare `pre_std` parameter, broadcast),
    `per_actuator_heads` (`mean_i` / `pre_std_i`) and `use_tanh_mean`, on a
    two-gripper graph over a HEPi backbone."""
    kw = HEADS[name]
    (jg, jf), (tg, tf) = both_graphs(toy_arrays(6, num_grippers=2))
    hepi = dict(latent_dim=W, hidden_dim=W, output_dim=1, output_dim_vec=1, num_ori=4)
    jpol = jm.DiagGaussianPolicy(backbone=jm.HEPi(**hepi), action_dim=6, num_actuators=2, init_std=0.7, **kw)
    tpol = tm.DiagGaussianPolicy(tm.HEPi(**SHAPE, **hepi), W, action_dim=6, num_actuators=2, init_std=0.7, **kw)
    params = jax.jit(lambda key: jpol.init(key, jg, jf))(jax.random.PRNGKey(3))
    state = params_from_flax(np_tree(params))
    tpol.load_state_dict(state)
    heads = sorted(k for k in state if not k.startswith("backbone."))
    if name == "non_contextual_std":
        assert heads == ["mean.bias", "mean.weight", "pre_std"] and state["pre_std"].shape == (3,)
    elif name == "per_actuator_heads_non_contextual_std":
        assert "pre_std_0" in heads and "pre_std_1" in heads and "mean_1.weight" in heads
    jdist = jax.jit(lambda p: jpol.apply(p, jg, jf))(params)
    with torch.no_grad():
        tdist = tpol(tg, tf)
    assert tdist.mean.shape == (B, 6)
    # the orthogonal(0.01) heads make means of ~1e-2: hold them to the
    # latent's scale through the std, which is ~init_std
    np.testing.assert_allclose(tdist.mean.numpy(), np.asarray(jdist.mean), atol=1e-6, rtol=1e-5)
    assert_close(tdist.std.numpy(), jdist.std, 1e-5, "std")
    if not kw.get("contextual_std", True):
        # init_params draws the bare pre_std ~ normal(0.01)
        init_params(tpol, torch.Generator().manual_seed(1))
        bare = torch.cat([p.reshape(-1) for n, p in tpol.named_parameters() if n.startswith("pre_std")])
        assert 0 < bare.abs().max() < 0.1


def test_get_model_registry():
    assert sorted(tm.MODEL_REGISTRY) == sorted(jm.MODEL_REGISTRY)
    assert tm.MODEL_REGISTRY["empn"] is tm.MODEL_REGISTRY["ponita_gcn"] is tm.PonitaGCN
    assert isinstance(tm.get_model("GCN", in_dim=4, num_edge_types=2, hidden_dim=8), tm.GCN)
    with pytest.raises(ValueError, match=r"Unknown model 'nope'; available: \['deepsets', 'empn'"):
        tm.get_model("nope")
