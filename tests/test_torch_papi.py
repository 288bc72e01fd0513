"""PAPI's post-update steps of the PyTorch port against the JAX package
(`rl/projections/papi.py`, `Trainer.train_iteration_papi`), f32.

- `papi_project_with_intermed` on seeded distributions, and `papi_steps` in
  the reference's three cases (tests/test_projections.py): backtracking to
  a feasible history entry, a feasible current policy (no-op), and nothing
  feasible (params kept, LR annealed), on the reference's toy non-contextual
  MLP policy with its Flax params copied and the JAX `PAPIState` history
  carried across. The candidate index, the anneal flag and the history
  length must be equal.
- The trainer's PAPI steps on one collected batch of a rigid_pushing MLP
  agent (the family PAPI runs on: a Dense `mean` head, a non-contextual
  std), two rounds, the second carrying the first's history and starting
  from a perturbed mean head so that it backtracks.

Tolerances: the projected parameters within 1e-5 of max(1, each tensor's
largest entry): 20 interpolations whose weights come from batch means
summed in another order (~1e-7 relative each). `papi_project_with_intermed`:
1e-5 relative, 1e-6 absolute.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (pins torch to one thread per test worker)
from geometry_rl_tpu.models import MLPGaussianPolicy as JaxMLPPolicy
from geometry_rl_tpu.rl import gaussian as jax_gaussian
from geometry_rl_tpu.rl.projections import papi as jax_papi
from geometry_rl_torch.convert import batch_from_jax, params_from_flax
from geometry_rl_torch.models import MLPGaussianPolicy
from geometry_rl_torch.rl import gaussian
from geometry_rl_torch.rl.projections import papi
from test_torch_common import frozen, np_tree, port_agent, reference_agent

PARAM_TOL = 1e-5


def assert_params_close(got, ref, what):
    assert sorted(got) == sorted(ref), what
    for k, r in ref.items():
        r = np.asarray(r)
        err = np.abs(got[k].detach().numpy() - r).max()
        assert err <= PARAM_TOL * max(1.0, np.abs(r).max()), (what, k, err)


def history_to_port(history):
    """A JAX PAPIState history (a Flax tree stacked [H, ...]) as the port's
    {name: [H, ...]}."""
    h = jax.tree_util.tree_leaves(history)[0].shape[0]
    rows = [params_from_flax(np_tree(jax.tree_util.tree_map(lambda x: x[i], history))) for i in range(h)]
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


def state_to_port(state):
    return papi.PAPIState(history_to_port(state.history), torch.tensor(int(state.hist_len), dtype=torch.int32),
                          torch.tensor(float(state.lr_scale)))


@pytest.mark.parametrize("gate", ["open", "closed"])
def test_papi_project_with_intermed_matches_reference(gate):
    """The entropy gate open (bound -inf) and closed (a finite bound that
    the entropy projection enforces)."""
    rng = np.random.default_rng(11)
    n, a = 32, 4
    old_mean = rng.normal(size=(n, a)).astype(np.float32)
    old_std = np.broadcast_to(np.exp(rng.normal(scale=0.3, size=a)), (n, a)).astype(np.float32)
    mean = (old_mean + 0.4 * rng.normal(size=(n, a))).astype(np.float32)
    std = (old_std * 1.3).astype(np.float32)
    inter = (old_mean + 0.1 * rng.normal(size=(n, a))).astype(np.float32)
    bound = -np.inf if gate == "open" else float(jax_gaussian.entropy(jax_gaussian.DiagGaussian(mean, std)).mean()) + 0.5
    ref = jax_papi.papi_project_with_intermed(jax_gaussian.DiagGaussian(mean, std),
                                              jax_gaussian.DiagGaussian(old_mean, old_std), jnp.asarray(inter), 0.05,
                                              jnp.float32(bound))
    got = papi.papi_project_with_intermed(gaussian.DiagGaussian(torch.tensor(mean), torch.tensor(std)),
                                          gaussian.DiagGaussian(torch.tensor(old_mean), torch.tensor(old_std)),
                                          torch.tensor(inter), 0.05, torch.tensor(bound, dtype=torch.float32))
    assert 0.0 < float(ref[0]) < 1.0  # the line search is active
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)


def toy_policy(seed):
    """The reference test's toy policy (4 inputs, one hidden layer of 16, 2
    actions, non-contextual std) in both packages with the same params, its
    observations and apply functions."""
    jpol = JaxMLPPolicy(action_dim=2, hidden_dims=(16,), contextual_std=False)
    obs = jax.random.normal(jax.random.PRNGKey(seed), (32, 4))
    params0 = jpol.init(jax.random.PRNGKey(0), None, obs)
    tpol = MLPGaussianPolicy(4, 2, hidden_dims=(16,), contextual_std=False)
    obs_t = torch.tensor(np.asarray(obs))

    def j_apply(p):
        return jpol.apply(p, None, obs)

    def t_apply(p):
        return torch.func.functional_call(tpol, p, (None, obs_t))

    return params0, j_apply, t_apply


def perturb(params, scale):
    p = copy.deepcopy(params)
    p["params"]["mean"]["kernel"] = p["params"]["mean"]["kernel"] + scale
    p["params"]["mean"]["bias"] = p["params"]["mean"]["bias"] + scale
    return p


def run_both(j_apply, t_apply, current, jstate, q_params, bounds=(0.05, 0.005)):
    q = j_apply(q_params)
    e0 = jnp.asarray(float(jax_gaussian.entropy(q).mean()))
    jnew, jst, janneal, jidx = jax_papi.papi_steps(j_apply, current, jstate, q, *bounds, initial_entropy=e0)
    tq = gaussian.DiagGaussian(torch.tensor(np.asarray(q.mean)), torch.tensor(np.asarray(q.std)))
    tnew, tst, tanneal, tidx = papi.papi_steps(t_apply, params_from_flax(np_tree(current)), state_to_port(jstate), tq,
                                               *bounds, initial_entropy=torch.tensor(np.asarray(e0)))
    assert tidx == int(jidx) and tanneal == bool(janneal)
    assert int(tst.hist_len) == int(jst.hist_len) and tst.hist_len.dtype == torch.int32
    assert_params_close(tnew, params_from_flax(np_tree(jnew)), "params")
    assert_params_close(tst.history, history_to_port(jst.history), "history")
    return tidx, tanneal, tst


def test_papi_steps_backtrack_to_the_feasible_history_entry():
    params0, j_apply, t_apply = toy_policy(1)
    jstate = jax_papi.papi_init_state(params0, history=4)
    jstate = jstate._replace(history=jax.tree_util.tree_map(lambda h, p: h.at[0].set(p), jstate.history, params0),
                             hist_len=jnp.ones((), jnp.int32))
    idx, anneal, st = run_both(j_apply, t_apply, perturb(params0, 0.7), jstate, params0)
    assert idx == 1 and not anneal and int(st.hist_len) == 2


def test_papi_steps_keep_a_feasible_current_policy():
    params0, j_apply, t_apply = toy_policy(2)
    idx, anneal, st = run_both(j_apply, t_apply, params0, jax_papi.papi_init_state(params0, history=4), params0)
    assert idx == 0 and not anneal and int(st.hist_len) == 1


def test_papi_steps_anneal_when_nothing_is_feasible():
    params0, j_apply, t_apply = toy_policy(3)
    jstate = jax_papi.papi_init_state(perturb(params0, 5.0), history=4)
    idx, anneal, st = run_both(j_apply, t_apply, perturb(params0, 0.7), jstate, params0)
    assert idx == 1 and anneal and int(st.hist_len) == 0


def test_find_papi_paths_refuses_what_the_reference_refuses():
    """A contextual std, and a policy with no Dense `mean` head (HEPi: the
    equivariant output is the mean)."""
    pol = MLPGaussianPolicy(3, 2, hidden_dims=(8,), contextual_std=True)
    with pytest.raises(ValueError, match="non-contextual"):
        papi.find_papi_paths(dict(pol.named_parameters()))
    names = papi.find_papi_paths(dict(MLPGaussianPolicy(3, 2, hidden_dims=(8,), contextual_std=False).named_parameters()))
    assert names == ("mean.weight", "mean.bias", "pre_std")
    with pytest.raises(ValueError, match="Dense mean head"):
        papi.find_papi_paths({"backbone.readout.weight": torch.zeros(2, 2), "pre_std": torch.zeros(2)})
    out = papi.papi_weight_update({"w": torch.full((2,), 3.0)}, {"w": torch.ones(2)}, 0.5)
    assert out["w"].tolist() == [2.0, 2.0]


# ------------------------------------------------- the trainer's PAPI steps

SMALL = dict(num_envs=4, latent_dim=8, env_kwargs=dict(warmup_steps=0), contextual_std=False, proj_type="papi",
             init_std=0.7, minimal_std=1e-3)  # not the defaults: the PAPI steps invert the std head with them
CFG = dict(steps_per_batch=3, mini_batch_size=6, ppo_epochs=2, total_iterations=10, papi_steps=True, papi_iters=20)


def jax_papi_part(jtr, js, jbatch, jpapi):
    """The PAPI half of the reference's `train_iteration_papi`, after its
    `_update` (the same calls, without the collect and update)."""
    T, B = jtr.cfg.steps_per_batch, jtr.env.cfg.num_envs

    def flat(x):
        return x.reshape((T * B,) + x.shape[2:])

    tobs = jax.tree_util.tree_map(flat, jbatch.tobs)
    env_ids = jnp.tile(jnp.arange(B, dtype=jnp.int32), T)
    q = jax_gaussian.DiagGaussian(flat(jbatch.mean), flat(jbatch.std))
    apply_fn = jax.jit(lambda params: jtr._policy_dist(params, tobs, env_ids))
    new_params, jpapi, anneal, n_back = jax_papi.papi_steps(
        apply_fn, js.actor_params, jpapi, q, mean_bound=jtr.projection.mean_bound, cov_bound=jtr.projection.cov_bound,
        initial_entropy=js.initial_entropy, init_std=jtr.policy.init_std, minimal_std=jtr.policy.minimal_std,
        n_iters=jtr.cfg.papi_iters)
    jpapi = jpapi._replace(lr_scale=jpapi.lr_scale * jnp.where(anneal, jtr.cfg.papi_lr_decay, 1.0))
    return js._replace(actor_params=new_params), jpapi, int(n_back)


def test_trainer_papi_steps_match_reference():
    akw, tkw = frozen(**SMALL), frozen(**CFG)
    jtr, js0 = reference_agent("rigid_pushing", "mlp", akw, tkw, seed=3)
    js1, jbatch, _ = jax.jit(jtr._collect)(js0)
    js2, _ = jax.jit(jtr._update)(js1, jbatch)
    ttr, state = port_agent("rigid_pushing", "mlp", js2, akw, tkw)
    batch = batch_from_jax(np_tree(jbatch))

    jpapi = jtr.papi_init(js2)
    tpapi = ttr.papi_init(state)
    assert int(tpapi.hist_len) == 0 and float(tpapi.lr_scale) == 1.0
    for rnd in range(2):
        if rnd == 1:
            # the second round starts from a perturbed mean head: it backtracks
            # to the entry the first round pushed
            js2 = js2._replace(actor_params=perturb(js2.actor_params, 0.5))
            ttr.policy.load_state_dict(params_from_flax(np_tree(js2.actor_params)))
        js3, jpapi, j_back = jax_papi_part(jtr, js2, jbatch, jpapi)
        tpapi, metrics = ttr._papi_steps(state, batch, tpapi)
        assert metrics["papi/n_backtracks"].item() == j_back == rnd
        assert metrics["papi/lr_scale"].item() == float(jpapi.lr_scale) == 1.0
        assert int(tpapi.hist_len) == int(jpapi.hist_len) == rnd + 1
        assert_params_close(dict(ttr.policy.named_parameters()), params_from_flax(np_tree(js3.actor_params)), "policy")
        assert_params_close(tpapi.history, history_to_port(jpapi.history), "history")
        js2 = js3
