"""The fused cloth position solve in the PyTorch port.

The port's plain version (`cloth_position_solve_ref`) is held against both
Pallas kernels of the JAX package, run in interpret mode on the CPU, on the
real cloth_hanging topology with self-collision off and on. The CUDA kernel is
held against the plain version on the card in tests/test_torch_cuda.py.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import test_torch_common  # noqa: F401  (pins torch to one thread per test worker)

from geometry_rl_tpu.envs import make_env as jax_make_env
from geometry_rl_tpu.sim.pallas_cloth import cloth_position_solve, cloth_position_solve_tiled
from geometry_rl_torch.envs import make_env
from geometry_rl_torch.sim.cloth_solve import (
    _ATT_CHECKED,
    _check_att_once,
    check_conflict_free,
    check_kernel_limits,
    cloth_position_solve as port_solve,
    cloth_position_solve_cuda,
    cloth_position_solve_env_cuda,
    cloth_position_solve_ref,
    pack_groups,
    solve_cost,
)
from geometry_rl_torch.utils.trace import counting

# the JAX package's own Pallas-vs-XLA gate (tests/test_envs_cloth.py); both
# sides are f32 and differ only in summation order (~1e-6 seen)
ATOL = 2e-4
B = 2


def solve_operands(je, seed):
    """Numpy operands of one substep's solve from a JAX reset layout: the cloth
    folded over itself along its middle row (rows 8..14 laid 4 cm above rows
    6..0, so particles across the fold sit closer than the self-collision
    distance; the grippers follow their corners), jittered by 5 mm, with the
    hook through the cloth's centre so contact is exercised."""
    state = je.reset(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    prev = np.concatenate([np.asarray(state.scene.particles.pos), np.asarray(state.scene.bodies.pos)], 1)
    grid = prev[:, :225].reshape(-1, 15, 15, 3)
    normal = np.cross(grid[:, 0, 1] - grid[:, 0, 0], grid[:, 1, 0] - grid[:, 0, 0])
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    folded = grid.copy()
    folded[:, 8:] = grid[:, 6::-1] + 0.04 * normal[:, None, None, :]
    x = prev.copy()
    x[:, :225] = folded.reshape(-1, 225, 3)
    x[:, 225:] = x[:, np.asarray(je.corner_indices)]  # the grippers follow their corners
    x = (x + rng.normal(0.0, 0.005, x.shape)).astype(np.float32)
    hanger = (x[:, 112] + np.array([0.03, -0.3, 0.0], np.float32)).astype(np.float32)
    return x, prev.astype(np.float32), hanger


def jax_solve(je, kernel, x, prev, hanger):
    n = x.shape[0]
    inv_all = jnp.concatenate(
        [je.particle_spec.inv_mass, jnp.broadcast_to(je.body_spec.inv_mass[None], (n, 4))], axis=1
    )
    bw = jnp.broadcast_to(je.body_spec.inv_mass[None], (n, 4))
    fn = cloth_position_solve_tiled if kernel == "tiled" else cloth_position_solve
    out = fn(
        je.solve_spec, jnp.asarray(x), jnp.asarray(prev), inv_all, jnp.asarray(hanger), bw,
        je.corner_indices, je.group_topology, je.group_mask_list,
        je.self_pair_mask_full, je.self_active_full, True,
    )
    return np.asarray(out)


def port_operands(te, x, prev, hanger, spec=None):
    return (
        spec or te.solve_spec, torch.as_tensor(x), torch.as_tensor(prev), te.inv_all, torch.as_tensor(hanger),
        te.att_body_w, te.corner_indices, te.groups, te.self_pair_mask_full, te.self_active_full,
    )


@pytest.fixture(scope="module", params=[False, True], ids=["no_self_collision", "self_collision"])
def envs(request):
    kw = dict(num_envs=B, warmup_steps=0, self_collision=request.param)
    je = jax_make_env("cloth_hanging", use_pallas_solver="tiled", **kw)
    te = make_env("cloth_hanging", device="cpu", **kw)
    return je, te, solve_operands(je, seed=3)


@pytest.mark.parametrize("kernel", ["tiled", "per_env"])
def test_plain_solve_matches_pallas_kernels(envs, kernel):
    je, te, (x, prev, hanger) = envs
    ref = jax_solve(je, kernel, x, prev, hanger)
    out = cloth_position_solve_ref(*port_operands(te, x, prev, hanger)).numpy()
    assert np.abs(ref - x).max() > 1e-2  # the solve really moves the state
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_operands_exercise_contact_and_self_collision(envs):
    """Each optional pass changes the result, so the parity above covers it."""
    _, te, (x, prev, hanger) = envs
    full = cloth_position_solve_ref(*port_operands(te, x, prev, hanger))
    no_hook = te.solve_spec._replace(hook_radius=0.0)
    assert (full - cloth_position_solve_ref(*port_operands(te, x, prev, hanger, no_hook))).abs().max() > 1e-3
    if te.solve_spec.self_min_dist > 0:
        no_self = te.solve_spec._replace(self_min_dist=0.0)
        assert (full - cloth_position_solve_ref(*port_operands(te, x, prev, hanger, no_self))).abs().max() > 1e-4


def test_cpu_tensors_take_the_plain_version(envs):
    _, te, (x, prev, hanger) = envs
    args = port_operands(te, x, prev, hanger)
    with counting("kernels.cloth_solve") as launched:
        assert torch.equal(port_solve(*args), cloth_position_solve_ref(*args))
    assert launched == {"kernels.cloth_solve": 0}
    with pytest.raises(ValueError, match="CUDA"):
        cloth_position_solve_cuda(*args)


def test_bad_groups_are_rejected():
    te = make_env("cloth_hanging", num_envs=B, warmup_steps=0, device="cpu")
    topo = []
    for g in te.distance_groups:
        topo += [g.i, g.j, g.rest]
    check_conflict_free(topo)  # the env's own groups pass
    bad = list(topo)
    bad[1] = bad[1].clone()
    bad[1][0] = bad[0][1]  # constraint 0 now ends on constraint 1's first particle
    with pytest.raises(ValueError, match="not conflict-free"):
        pack_groups(te.solve_spec, bad, [g.mask for g in te.distance_groups])
    out_of_range = list(topo)
    out_of_range[0] = out_of_range[0].clone()
    out_of_range[0][0] = 229  # past the last pseudo-particle
    with pytest.raises(ValueError, match="indices in"):
        pack_groups(te.solve_spec, out_of_range, [g.mask for g in te.distance_groups])


def test_kernel_limits_accept_the_cloth_env():
    te = make_env("cloth_hanging", num_envs=B, warmup_steps=0, self_collision=True, device="cpu")
    check_kernel_limits(te.solve_spec)
    check_kernel_limits(te.solve_spec, te.corner_indices.tolist())


def _spec_with(**change):
    spec = make_env("cloth_hanging", num_envs=1, warmup_steps=0, device="cpu").solve_spec
    return spec._replace(**change)


@pytest.mark.parametrize("case", ["group_of_129", "17_groups", "257_particles", "repeated_attachment",
                                  "attachment_on_a_gripper"])
def test_kernel_limits_reject_what_the_kernels_do_not_take(case):
    """Each limit of the CTA-per-env design raises before any launch, and the
    plain version still takes the shape."""
    corners = [0, 14, 210, 224]
    spec, att, match = {
        "group_of_129": (_spec_with(group_sizes=(105, 129)), corners, "128 constraints"),
        "17_groups": (_spec_with(group_sizes=(8,) * 17, group_compliance=(0.0,) * 17), corners, "16 distance groups"),
        "257_particles": (_spec_with(num_particles=253), corners, "256 particles"),
        "repeated_attachment": (_spec_with(), [0, 14, 14, 224], "distinct cloth indices"),
        "attachment_on_a_gripper": (_spec_with(), [0, 14, 210, 225], "distinct cloth indices"),
    }[case]
    with pytest.raises(ValueError, match=match):
        check_kernel_limits(spec, att)


@pytest.mark.parametrize("solve", [cloth_position_solve_cuda, cloth_position_solve_env_cuda])
def test_wrappers_check_limits_first(solve):
    """Each wrapper refuses a spec outside the kernels' limits before it
    looks at the tensors, so a CUDA tensor never reaches the launch with it;
    with a spec inside them, CPU tensors are refused for their device."""
    te = make_env("cloth_hanging", num_envs=B, warmup_steps=0, device="cpu")
    je = jax_make_env("cloth_hanging", num_envs=B, warmup_steps=0, use_pallas_solver="tiled")
    spec, *rest = port_operands(te, *solve_operands(je, seed=1))
    with counting("kernels.cloth_solve", "kernels.cloth_solve_env") as launched:
        with pytest.raises(ValueError, match="16 distance groups"):
            solve(spec._replace(group_sizes=(8,) * 17), *rest)
        with pytest.raises(ValueError, match="CUDA"):
            solve(spec, *rest)
    assert launched == {"kernels.cloth_solve": 0, "kernels.cloth_solve_env": 0}


def test_plain_version_counts_contacts_and_self_hits(envs):
    """`events` reports the data-dependent work without changing the result:
    particles on the hook, and violating pairs only with self-collision on."""
    _, te, (x, prev, hanger) = envs
    events = {"contacts": -1}
    out = cloth_position_solve_ref(*port_operands(te, x, prev, hanger), events=events)
    assert torch.equal(out, cloth_position_solve_ref(*port_operands(te, x, prev, hanger)))
    spec = te.solve_spec
    assert 0 < events["contacts"] < B * spec.iterations * spec.num_particles  # the hook through the centre
    assert (events["self_hits"] > 0) == (spec.self_min_dist > 0)
    off_hook = {}
    cloth_position_solve_ref(*port_operands(te, x, prev, hanger, spec._replace(hook_radius=0.0)), events=off_hook)
    assert off_hook["contacts"] == 0


def test_attachment_check_is_cached_per_tensor_and_dropped_with_it():
    spec = _spec_with()
    att = torch.tensor([0, 14, 210, 224], dtype=torch.int32)
    _check_att_once(spec, att)
    key = id(att)
    assert _ATT_CHECKED[key] == att._version
    att[2] = 14  # an in-place change is checked again
    with pytest.raises(ValueError, match="distinct cloth indices"):
        _check_att_once(spec, att)
    del att
    gc.collect()
    assert key not in _ATT_CHECKED


@pytest.mark.parametrize("self_collision", [False, True], ids=["no_self_collision", "self_collision"])
def test_solve_cost_counts_every_operand_once(self_collision):
    """`solve_cost` at B = 100: the bytes of every operand the kernels read
    and of the output, to the byte; the operations every iteration does, and
    those of the contacts and self-collision hits it is given."""
    te = make_env("cloth_hanging", num_envs=100, warmup_steps=0, self_collision=self_collision, device="cpu")
    spec, g = te.solve_spec, te.groups
    x = torch.zeros((100, 229, 3))
    operands = [x, x, te.inv_all, torch.zeros((100, 3)), te.att_body_w, te.corner_indices,
                g.i, g.j, g.rest, g.mask, g.offset, g.compliance, x]  # x, prev_x, ..., out
    if self_collision:
        operands += [te.self_pair_mask_full, te.self_active_full]
    nbytes, flops = solve_cost(spec, 100)
    assert nbytes == sum(t.numel() * t.element_size() for t in operands)
    if not self_collision:
        assert nbytes == 1_414_140
    c, P, G, PT, n_g = 1202, 225, 4, 229, 12
    assert len(spec.group_sizes) == n_g
    per_iter = 31 * c + 29 * G + 14 * P + ((18 * PT * PT + 7 * PT) if self_collision else 0)
    assert flops == 100 * (3 * c + 2 * G + n_g + 10 * per_iter)
    assert solve_cost(spec, 100, contacts=5, self_hits=7) == (nbytes, flops + 5 * 42 + 7 * 13)
