"""The port in bfloat16 against the JAX package in bfloat16.

Every shared config trains with `algorithm.dtype: bfloat16` (f32 params,
bf16 activations). Both packages get the same f32 params and inputs and run
with `dtype=bfloat16`: the HEPi and EMPN policies and the DeepSets critic
forward on the cloth graph and the one-gripper rigid graph, and one HEPi
`_update` on each.

Tolerance of a forward, relative to the largest entry of the f32 reference's
action mean: bf16 keeps 8 significant bits, so one rounding is off by up to
2^-8 = 3.9e-3. A policy forward rounds about 25 times in sequence (node
encoder; the basis' two Dense + GELU; per conv round a kernel Dense, the
message product, the scatter's single rounding, the fiber contraction, a
LayerNorm, two Dense and the residual; the decoder), and independent
roundings add like a random walk: sqrt(25) * 3.9e-3 = 2e-2 per program. The
two programs round at different places (XLA fuses, PyTorch rounds after every
op), so they differ by sqrt(2) of that, and the mean, a signed sum over
orientations, cancels to about half its terms' size: 2e-2 * 1.4 * 2 ~ 5e-2.
Measured: 5e-3 (rigid) to 2e-2 (cloth), the same size as the reference's own
bf16-vs-f32 gap.

The f32 accumulation points are checked apart: the scatter-add sums bf16
messages in f32 and rounds once (bit-equal to the reference's one-hot
contraction), and the decoder / readout output is cast to f32 BEFORE the
orientation mean and the vector readout (`geometry_rl_tpu/models/hepi.py:126-134`,
`ponita_gcn.py:75-76`), so the action mean is not a bf16 number.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometry_rl_tpu.models.common import scatter_sum as jax_scatter_sum
from geometry_rl_torch import convert
from geometry_rl_torch.models.common import scatter_sum
from test_torch_common import frozen, np_tree, port_agent, reference_agent, reference_forward, reference_tobs, reference_trainer

BF16_RTOL = 5e-2
SMALL = dict(latent_dim=8, num_ori=4)
ENV_KW = {"rigid_insertion": dict(warmup_steps=0), "cloth_hanging": dict(warmup_steps=0, use_pallas_solver=False)}


@pytest.mark.parametrize("task", list(ENV_KW))
@pytest.mark.parametrize("model", ["hepi", "empn"])
def test_bf16_forward_matches_reference(model, task):
    kw = dict(num_envs=2, env_kwargs=ENV_KW[task], **SMALL)
    jtr32, js = reference_agent(task, model, frozen(**kw))
    jtr16 = reference_trainer(task, model, frozen(dtype=jnp.bfloat16, **kw))  # the same f32 params serve both
    ttr, _ = port_agent(task, model, js, frozen(**kw), dtype=torch.bfloat16)
    assert ttr.policy.backbone.dtype == ttr.critic.backbone.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in ttr.policy.parameters())
    jt, tt = reference_tobs(js)
    ref32, _ = reference_forward(jtr32, js.actor_params, js.critic_params, jt)
    ref16, ref_v = reference_forward(jtr16, js.actor_params, js.critic_params, jt)
    ref_v = np.asarray(ref_v)
    with torch.no_grad():
        got, value = ttr._policy_dist(tt), ttr._value(tt)
    scale = np.abs(np.asarray(ref32.mean)).max()
    gap = np.abs(got.mean.numpy() - np.asarray(ref16.mean)).max() / scale
    own = np.abs(np.asarray(ref16.mean) - np.asarray(ref32.mean)).max() / scale
    assert own > 1e-4, "the reference did not compute in bf16"
    assert gap <= BF16_RTOL, (gap, own)
    # the std head reads the f32 latent mean through orthogonal(0.01) weights
    np.testing.assert_allclose(got.std.numpy(), np.asarray(ref16.std), rtol=BF16_RTOL * 1e-1)
    # DeepSets: masked sum pool and two LayerNorms, 8 roundings
    assert np.abs(value.numpy() - ref_v).max() <= BF16_RTOL * max(np.abs(ref_v).max(), 1e-2)
    # outputs are f32, and the mean was not rounded to bf16 after the f32 cast
    assert got.mean.dtype == got.std.dtype == value.dtype == torch.float32
    assert (got.mean.bfloat16().float() != got.mean).any()


def test_bf16_scatter_accumulates_in_f32():
    """bf16 messages: summed in f32, rounded once: bit-equal to the
    reference's contraction and to the f32 sum of the same bf16 values."""
    rng = np.random.default_rng(0)
    m = rng.normal(size=(3, 40, 4, 8)).astype(np.float32)
    dst = rng.integers(0, 5, (3, 40))
    got = scatter_sum(torch.as_tensor(m).bfloat16(), torch.as_tensor(dst), 5)
    assert got.dtype == torch.bfloat16
    ref = jax_scatter_sum(jnp.asarray(m, jnp.bfloat16), jnp.asarray(dst, jnp.int32), 5)
    assert np.array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))
    exact = scatter_sum(torch.as_tensor(m).bfloat16().float(), torch.as_tensor(dst), 5)
    assert torch.equal(got, exact.bfloat16())
    # 8 bf16 addends per node in sequence would be off by up to 8 * 2^-9 of the sum's size
    assert (got.float() - exact).abs().max() <= 2.0**-8 * exact.abs().max()


CFG = dict(steps_per_batch=3, mini_batch_size=6, ppo_epochs=2, total_iterations=10)


@pytest.mark.parametrize("task", list(ENV_KW))
def test_bf16_update_matches_reference(task):
    """One HEPi `_update` (2 epochs x 2 minibatches of 6) in bf16 from the
    JAX agent's batch and permutations. Adam normalises each entry's step to
    ~lr whatever the gradient's size, so a few-percent gradient gap flips
    the entries near zero: the two updates are held as directions (cosine
    >= 0.95; measured 0.99) and by the metrics that are first-order in the
    params (5e-2 relative). The KL-type metrics are squares of a ~1e-2 step
    (1e-8 to 1e-3 here) and are held relative to the trust region's bound."""
    kw = dict(num_envs=4, env_kwargs=ENV_KW[task], **SMALL)
    jtr, js0 = reference_agent(task, "hepi", frozen(dtype=jnp.bfloat16, **kw), frozen(**CFG), seed=2)
    js1, jbatch, _ = jax.jit(jtr._collect)(js0)
    js2, jm = jax.jit(jtr._update)(js1, jbatch)
    ttr, state = port_agent(task, "hepi", js1, frozen(**kw), frozen(**CFG), dtype=torch.bfloat16)
    key, perms = js1.key, []
    for _ in range(CFG["ppo_epochs"]):
        key, k_perm = jax.random.split(key)
        perms.append(torch.as_tensor(np.array(jax.random.permutation(k_perm, 12).reshape(2, 6))))
    perm_iter = iter(perms)
    ttr._permutation = lambda generator, n: next(perm_iter)
    before = {k: v.clone() for k, v in ttr.policy.state_dict().items()}
    state, tm = ttr._update(state, convert.batch_from_jax(np_tree(jbatch)))
    ref = convert.params_from_flax(np_tree(js2.actor_params))
    d_port = torch.cat([(ttr.policy.state_dict()[k] - before[k]).reshape(-1) for k in before])
    d_ref = torch.cat([(ref[k] - before[k]).reshape(-1) for k in before])
    assert d_ref.abs().max() > 1e-4
    assert (d_port @ d_ref / (d_port.norm() * d_ref.norm())).item() >= 0.95
    assert sorted(tm) == sorted(jm)
    for k in ("entropy", "policy_std", "policy_std_min", "loss_critic", "loss_entropy", "ESS"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=BF16_RTOL, err_msg=k)
    # on one minibatch from the same params the gradient norms agree to 1%; over
    # the 4 steps the trust-region term's gradient grows with the squared gap
    np.testing.assert_allclose(tm["grad_norm_actor"].item(), float(jm["grad_norm_actor"]), rtol=0.25)
    for k in ("kl", "mean_constraint"):  # 5e-2 of the trust region's mean bound, 0.05
        assert abs(tm[k].item() - float(jm[k])) <= BF16_RTOL * 0.05, (k, tm[k].item(), float(jm[k]))
