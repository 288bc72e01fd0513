"""Tests of the port that need an NVIDIA card (marked `cuda`; each skips itself
where there is none). The file imports neither jax nor the JAX package, so it
also runs on a machine with only PyTorch:

    python -m pytest tests/test_torch_cuda.py -q -p no:cacheprovider --noconftest
"""

import pytest
import torch

from geometry_rl_torch.config import _merge, load_config, trainer_from_config
from geometry_rl_torch.envs import make_env
from geometry_rl_torch.graphs.types import csr_from_index
from geometry_rl_torch.models.common import gather_nodes, scatter_sum
from geometry_rl_torch.models.segment import LAUNCHES as SEGMENT_LAUNCHES
from geometry_rl_torch.models.segment import ON_THE_SPOT, segment_sum_cuda, segment_sum_ref
from geometry_rl_torch.rl.obs_pipeline import obs_norm_apply
from geometry_rl_torch.sim.cloth_solve import (
    LAUNCHES,
    cloth_position_solve_cuda,
    cloth_position_solve_env_cuda,
    cloth_position_solve_ref,
)

ATOL = 2e-4  # the JAX package's own Pallas-vs-XLA gate for the cloth solve
# K2's port and K1's: one design (csrc/cloth_solve_common.cuh), two operation orders
KERNELS = {"cloth_solve": cloth_position_solve_cuda, "cloth_solve_env": cloth_position_solve_env_cuda}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def folded_operands(env, seed):
    """One substep's solve operands: the cloth folded over itself along its
    middle row (4 cm apart, inside the self-collision distance; the grippers
    follow their corners), jittered by 5 mm, with the hook through the
    cloth's centre."""
    g = torch.Generator(device=env.device).manual_seed(seed)
    state = env.reset(g)
    B = env.cfg.num_envs
    prev = torch.cat([state.scene.particles.pos, state.scene.bodies.pos], 1).contiguous()
    grid = prev[:, :225].reshape(B, 15, 15, 3)
    normal = torch.linalg.cross(grid[:, 0, 1] - grid[:, 0, 0], grid[:, 1, 0] - grid[:, 0, 0], dim=-1)
    normal = normal / torch.linalg.vector_norm(normal, dim=-1, keepdim=True)
    folded = grid.clone()
    folded[:, 8:] = grid[:, :7].flip(1) + 0.04 * normal[:, None, None, :]
    x = prev.clone()
    x[:, :225] = folded.reshape(B, 225, 3)
    x[:, 225:] = x[:, env.corner_indices.long()]  # the grippers follow their corners
    x = (x + 0.005 * torch.randn(x.shape, generator=g, device=env.device)).contiguous()
    hanger = (x[:, 112] + torch.tensor([0.03, -0.3, 0.0], device=env.device)).contiguous()
    return (env.solve_spec, x, prev, env.inv_all, hanger, env.att_body_w, env.corner_indices, env.groups,
            env.self_pair_mask_full, env.self_active_full)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("num_envs,self_collision", [(100, False), (1000, False), (4, True)])
def test_cuda_kernel_matches_plain_version(cuda_device, num_envs, self_collision, kernel):
    env = make_env("cloth_hanging", num_envs=num_envs, warmup_steps=0, self_collision=self_collision, device=cuda_device)
    args = folded_operands(env, seed=3)
    before = dict(LAUNCHES)
    out = KERNELS[kernel](*args)
    torch.cuda.synchronize()
    assert LAUNCHES == {**before, kernel: before[kernel] + 1}
    assert (out - cloth_position_solve_ref(*args)).abs().max().item() <= ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("num_envs,self_collision", [(100, False), (4, True)])
def test_k1_port_matches_k2_port(cuda_device, num_envs, self_collision):
    """The two instantiations differ only in operation order."""
    env = make_env("cloth_hanging", num_envs=num_envs, warmup_steps=0, self_collision=self_collision, device=cuda_device)
    args = folded_operands(env, seed=5)
    k1, k2 = cloth_position_solve_env_cuda(*args), cloth_position_solve_cuda(*args)
    assert (k1 - k2).abs().max().item() <= ATOL
    assert (k2 - args[1]).abs().max().item() > 1e-2  # the solve really moved the state


@pytest.mark.cuda
def test_main_path_kernels_do_not_spill(cuda_device):
    """What ptxas reported when it built the libraries: the instantiations the
    main paths launch (self-collision off) keep everything in registers."""
    from geometry_rl_torch.cuda_build import BUILD_INFO, load_library

    for lib, kernel in (("cloth_solve", "cloth_solve_kernel"), ("cloth_solve_env", "cloth_solve_env_kernel")):
        load_library(lib)
        info = BUILD_INFO[lib][kernel]
        assert info["registers"] > 0 and info["spill_store_bytes"] == 0 and info["spill_load_bytes"] == 0, info


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_cuda_kernel_rejects_bad_operands(cuda_device, kernel):
    solve = KERNELS[kernel]
    env = make_env("cloth_hanging", num_envs=4, warmup_steps=0, device=cuda_device)
    spec, x, *rest = folded_operands(env, seed=0)
    with pytest.raises(TypeError, match="dtype"):
        solve(spec, x.double(), *rest)
    with pytest.raises(ValueError, match="contiguous"):
        solve(spec, x.transpose(0, 1).contiguous().transpose(0, 1), *rest)
    with pytest.raises(ValueError, match="on cpu"):
        solve(spec, x, rest[0].cpu(), *rest[1:])
    with pytest.raises(ValueError, match="particles"):
        solve(spec, x[:, :-1].contiguous(), *rest)
    with pytest.raises(ValueError, match="distinct cloth indices"):
        solve(spec, x, *rest[:4], torch.tensor([0, 14, 14, 224], dtype=torch.int32, device=cuda_device), *rest[5:])


@pytest.mark.cuda
def test_per_env_solver_mode_launches_only_its_kernel(cuda_device):
    """`use_pallas_solver=True` steps through K1's port alone: 2 substeps per
    control step, one launch each."""
    env = make_env("cloth_hanging", num_envs=8, warmup_steps=0, use_pallas_solver=True, device=cuda_device)
    state = env.reset(torch.Generator(device=cuda_device).manual_seed(0))
    LAUNCHES.update(cloth_solve=0, cloth_solve_env=0)
    for _ in range(3):
        state, ts = env.step(state, torch.zeros((8, env.cfg.action_dim), device=cuda_device))
    torch.cuda.synchronize()
    assert LAUNCHES == {"cloth_solve": 0, "cloth_solve_env": 6}
    assert torch.isfinite(state.scene.particles.pos).all() and torch.isfinite(ts.reward).all()


@pytest.mark.cuda
def test_cuda_slice_matches_cpu(cuda_device):
    """Three deterministic rollout steps of the f32 slice on the card against
    the same steps on the CPU (where the solve is the plain version), relative
    to each quantity's scale: the untrained policy's mean actions reach ~1e2."""
    cfg = load_config("cloth_hanging_multi_hepi_trpl", overrides={
        "env": {"num_envs": 4, "kwargs": {"warmup_steps": 2}}, "algorithm": {"latent_dim": 16, "num_ori": 4, "dtype": "float32"},
    })
    gpu, cpu = trainer_from_config(cfg, device=cuda_device), trainer_from_config(cfg, device="cpu")
    state = gpu.init(torch.Generator(device=cuda_device).manual_seed(0))
    cpu.policy.load_state_dict(gpu.policy.state_dict())
    eg = state.env_state
    ec = eg._replace(
        scene=type(eg.scene)(*(type(p)(*(t.cpu() for t in p)) for p in eg.scene)),
        hanger_pos=eg.hanger_pos.cpu(), episode_step=eg.episode_step.cpu(), prev_action=eg.prev_action.cpu(),
        generator=torch.Generator().manual_seed(0),
    )
    norm_c = type(state.norm)(*(type(v)(*(t.cpu() for t in v)) for v in state.norm))
    from geometry_rl_torch.rl.obs_pipeline import obs_norm_step

    with torch.no_grad():
        for _ in range(3):
            a_g = gpu._policy_dist(obs_norm_step(state.norm, gpu.env.observe(eg), update=False)[1]).mean
            a_c = cpu._policy_dist(obs_norm_step(norm_c, cpu.env.observe(ec), update=False)[1]).mean
            eg, ts_g = gpu.env.step(eg, a_g)
            ec, ts_c = cpu.env.step(ec, a_c)
            for g, c in ((a_g, a_c), (ts_g.reward, ts_c.reward), (eg.scene.particles.pos, ec.scene.particles.pos)):
                assert (g.cpu() - c).abs().max().item() <= 1e-4 * max(1.0, c.abs().max().item())


@pytest.mark.cuda
def test_train_iteration_on_the_card_is_finite(cuda_device):
    """One small collect + update on the card with `use_pallas_solver=True`:
    finite metrics, params that moved, and K1's port the only solve."""
    cfg = load_config("cloth_hanging_multi_hepi_trpl", overrides={
        "env": {"num_envs": 8, "kwargs": {"warmup_steps": 1, "episode_length": 4, "use_pallas_solver": True}},
        "collector": {"frames_per_batch": 64}, "algorithm": {"latent_dim": 16, "num_ori": 4, "objective": {"mini_batch_size": 16}},
    })
    trainer = trainer_from_config(cfg, device=cuda_device)
    LAUNCHES.update(cloth_solve=0, cloth_solve_env=0)
    state = trainer.init(torch.Generator(device=cuda_device).manual_seed(0))
    before = {k: v.clone() for k, v in trainer.policy.state_dict().items()}
    state, metrics = trainer.train_iteration(state)
    torch.cuda.synchronize()
    assert LAUNCHES == {"cloth_solve": 0, "cloth_solve_env": 2 * (1 + 8)}
    assert state.num_updates == 5 * 4
    assert all(torch.isfinite(v).all() for v in metrics.values()), metrics
    assert any((trainer.policy.state_dict()[k] - v).abs().max() > 0 for k, v in before.items())


# ------------------------------------------------------------ the rigid path


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["rigid_insertion", "rigid_pushing", "rigid_sliding", "rigid_insertion_two_agents"])
def test_rigid_env_on_the_card_matches_cpu(cuda_device, task):
    """Three steps of each rigid task on the card and on the CPU from the
    same state and actions: body poses within 1e-5 (f32 sums in another
    order), no cloth kernel launched."""
    gpu = make_env(task, num_envs=8, warmup_steps=2, device=cuda_device)
    cpu = make_env(task, num_envs=8, warmup_steps=2, device="cpu")
    sg = gpu.reset(torch.Generator(device=cuda_device).manual_seed(0))
    sc = sg._replace(scene=type(sg.scene)(bodies=type(sg.scene.bodies)(*(t.cpu() for t in sg.scene.bodies))),
                     episode_step=sg.episode_step.cpu(), prev_action=sg.prev_action.cpu(),
                     generator=torch.Generator().manual_seed(0))
    actions = torch.rand((3, 8, gpu.cfg.action_dim), generator=torch.Generator().manual_seed(1)) * 2.4 - 1.2
    LAUNCHES.update(cloth_solve=0, cloth_solve_env=0)
    for a in actions:
        sg, ts_g = gpu.step(sg, a.to(cuda_device))
        sc, ts_c = cpu.step(sc, a)
    torch.cuda.synchronize()
    assert LAUNCHES == {"cloth_solve": 0, "cloth_solve_env": 0}
    for got, ref in ((sg.scene.bodies.pos, sc.scene.bodies.pos), (sg.scene.bodies.quat, sc.scene.bodies.quat),
                     (ts_g.reward, ts_c.reward)):
        assert (got.cpu() - ref).abs().max().item() <= 1e-5


@pytest.mark.cuda
def test_rigid_step_does_not_synchronise(cuda_device):
    """The rigid env step reads nothing back to the host: with CUDA's sync
    debug mode set to error, two steps (after a warm-up step) run through."""
    env = make_env("rigid_insertion", num_envs=64, warmup_steps=0, device=cuda_device)
    state = env.reset(torch.Generator(device=cuda_device).manual_seed(0))
    action = torch.zeros((64, env.cfg.action_dim), device=cuda_device)
    state, _ = env.step(state, action)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            state, ts = env.step(state, action)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.isfinite(state.scene.bodies.pos).all() and torch.isfinite(ts.reward).all()


@pytest.mark.cuda
def test_rigid_train_iteration_on_the_card_is_finite(cuda_device):
    """One small rigid_insertion collect + update on the card: finite
    metrics, params that moved, and neither cloth kernel launched."""
    cfg = load_config("rigid_insertion_multi_hepi_trpl", overrides={
        "env": {"num_envs": 16, "kwargs": {"warmup_steps": 1, "episode_length": 4}},
        "collector": {"frames_per_batch": 128}, "algorithm": {"latent_dim": 16, "num_ori": 4, "objective": {"mini_batch_size": 32}},
    })
    trainer = trainer_from_config(cfg, device=cuda_device)
    LAUNCHES.update(cloth_solve=0, cloth_solve_env=0)
    state = trainer.init(torch.Generator(device=cuda_device).manual_seed(0))
    before = {k: v.clone() for k, v in trainer.policy.state_dict().items()}
    state, metrics = trainer.train_iteration(state)
    torch.cuda.synchronize()
    assert LAUNCHES == {"cloth_solve": 0, "cloth_solve_env": 0}
    assert state.num_updates == 5 * 4
    assert all(torch.isfinite(v).all() for v in metrics.values()), metrics
    assert any((trainer.policy.state_dict()[k] - v).abs().max() > 0 for k, v in before.items())


@pytest.mark.cuda
def test_rigid_collect_does_not_synchronise(cuda_device):
    """The whole rigid_insertion collect (obs normaliser, graph builders,
    HEPi, critic, action sampling, env step) after a warm-up collect, under
    CUDA's sync debug mode set to error."""
    cfg = load_config("rigid_insertion_multi_hepi_trpl", overrides={
        "env": {"num_envs": 16, "kwargs": {"warmup_steps": 0}}, "collector": {"frames_per_batch": 32},
        "algorithm": {"latent_dim": 16, "num_ori": 4},
    })
    trainer = trainer_from_config(cfg, device=cuda_device)
    state = trainer.init(torch.Generator(device=cuda_device).manual_seed(0))
    state, _, _ = trainer._collect(state)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, batch, _ = trainer._collect(state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(batch.reward).all()


def tree_to(obj, device):
    """Tensors of a NamedTuple tree moved to `device`; a generator is replaced."""
    if torch.is_tensor(obj):
        return obj.to(device)
    if isinstance(obj, torch.Generator):
        return torch.Generator(device=device).manual_seed(0)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(tree_to(o, device) for o in obj))
    return obj


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["rope_closing", "rope_shaping"])
def test_rope_env_on_the_card_matches_cpu(cuda_device, task):
    """Three steps of each rope task on the card and on the CPU from the same
    state and actions: link and gripper positions and rewards within 1e-5
    (f32 sums in another order), no cloth kernel launched."""
    kw = dict(num_envs=8, num_links=20, rope_length=2.5, warmup_steps=2)
    gpu, cpu = make_env(task, device=cuda_device, **kw), make_env(task, device="cpu", **kw)
    sg = gpu.reset(torch.Generator(device=cuda_device).manual_seed(0))
    sc = tree_to(sg, "cpu")
    actions = torch.rand((3, 8, 6), generator=torch.Generator().manual_seed(1)) * 2.4 - 1.2
    LAUNCHES.update(cloth_solve=0, cloth_solve_env=0)
    for a in actions:
        sg, ts_g = gpu.step(sg, a.to(cuda_device))
        sc, ts_c = cpu.step(sc, a)
    torch.cuda.synchronize()
    assert LAUNCHES == {"cloth_solve": 0, "cloth_solve_env": 0}
    for got, ref in ((sg.scene.particles.pos, sc.scene.particles.pos), (sg.scene.bodies.pos, sc.scene.bodies.pos),
                     (ts_g.reward, ts_c.reward)):
        assert (got.cpu() - ref).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["rope_closing", "rope_shaping"])
def test_rope_step_does_not_synchronise(cuda_device, task):
    """The rope env step (and the episode's end, with its fresh layout) reads
    nothing back to the host: with CUDA's sync debug mode set to error, four
    steps (after a warm-up step) run through an auto-reset."""
    env = make_env(task, num_envs=64, num_links=20, rope_length=2.5, warmup_steps=0, episode_length=3, device=cuda_device)
    state = env.reset(torch.Generator(device=cuda_device).manual_seed(0))
    action = torch.full((64, 6), 0.3, device=cuda_device)
    state, _ = env.step(state, action)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dones = []
        for _ in range(4):
            state, ts = env.step(state, action)
            dones.append(ts.done)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.stack(dones).any() and torch.isfinite(state.scene.particles.pos).all() and torch.isfinite(ts.reward).all()


@pytest.mark.cuda
def test_rope_collect_does_not_synchronise(cuda_device):
    """The whole rope_closing collect (obs normaliser, graph builders, HEPi,
    critic, action sampling, env step) after a warm-up collect, under CUDA's
    sync debug mode set to error."""
    cfg = load_config("rope_closing_hepi_trpl", overrides={
        "env": {"num_envs": 16, "kwargs": {"warmup_steps": 0, "num_links": 20, "rope_length": 2.5}},
        "collector": {"frames_per_batch": 32}, "algorithm": {"latent_dim": 16, "num_ori": 4},
    })
    trainer = trainer_from_config(cfg, device=cuda_device)
    state = trainer.init(torch.Generator(device=cuda_device).manual_seed(0))
    state, _, _ = trainer._collect(state)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, batch, _ = trainer._collect(state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(batch.reward).all()


@pytest.mark.cuda
def test_rope_train_iteration_on_the_card_is_finite(cuda_device):
    """One small rope_closing collect + update on the card: finite metrics,
    params that moved, and neither cloth kernel launched."""
    cfg = load_config("rope_closing_hepi_trpl", overrides={
        "env": {"num_envs": 16, "kwargs": {"warmup_steps": 1, "episode_length": 4, "num_links": 20, "rope_length": 2.5}},
        "collector": {"frames_per_batch": 128}, "algorithm": {"latent_dim": 16, "num_ori": 4, "objective": {"mini_batch_size": 32}},
    })
    trainer = trainer_from_config(cfg, device=cuda_device)
    LAUNCHES.update(cloth_solve=0, cloth_solve_env=0)
    state = trainer.init(torch.Generator(device=cuda_device).manual_seed(0))
    before = {k: v.clone() for k, v in trainer.policy.state_dict().items()}
    state, metrics = trainer.train_iteration(state)
    torch.cuda.synchronize()
    assert LAUNCHES == {"cloth_solve": 0, "cloth_solve_env": 0}
    assert state.num_updates == 5 * 4
    assert all(torch.isfinite(v).all() for v in metrics.values()), metrics
    assert any((trainer.policy.state_dict()[k] - v).abs().max() > 0 for k, v in before.items())


@pytest.mark.cuda
@pytest.mark.parametrize("self_collision", [False, True])
def test_cloth_xpbd_mode_matches_tiled_mode(cuda_device, self_collision):
    """`use_pallas_solver=False` (step_physics, plain PyTorch) against
    "tiled" (K2's port) on the card: both advance the same state each step
    for 3 control steps, particle and gripper positions within 2e-4; the
    XPBD mode launches neither kernel, the tiled one 2 per step."""
    kw = dict(num_envs=16, warmup_steps=0, self_collision=self_collision, device=cuda_device)
    env_x = make_env("cloth_hanging", use_pallas_solver=False, **kw)
    env_t = make_env("cloth_hanging", use_pallas_solver="tiled", **kw)
    assert env_x.solver_mode is False and env_t.solver_mode == "tiled"
    state = env_x.reset(torch.Generator(device=cuda_device).manual_seed(7))
    A = env_x.cfg.action_dim
    for t in range(3):
        action = torch.sin(torch.arange(16 * A, dtype=torch.float32, device=cuda_device).reshape(16, A) * 0.7 + t * 0.3)
        pre = env_x._apply_action(state.scene, action)
        LAUNCHES.update(cloth_solve=0, cloth_solve_env=0)
        sx = env_x._physics(pre, state.hanger_pos)
        assert LAUNCHES == {"cloth_solve": 0, "cloth_solve_env": 0}
        st = env_t._physics(pre, state.hanger_pos)
        assert LAUNCHES == {"cloth_solve": 2, "cloth_solve_env": 0}
        assert (st.particles.pos - sx.particles.pos).abs().max().item() <= ATOL
        assert (st.bodies.pos - sx.bodies.pos).abs().max().item() <= ATOL
        state = state._replace(scene=sx)


@pytest.mark.cuda
def test_velocity_pass_on_the_card_matches_cpu(cuda_device):
    """rigid_pushing with restitution and dynamic friction on: 3 steps on the
    card and on the CPU from the same state, body positions within 1e-5; the
    step with the material on does not synchronise either."""
    kw = dict(num_envs=8, warmup_steps=2, restitution=0.3, dynamic_friction_scale=1.0)
    gpu, cpu = make_env("rigid_pushing", device=cuda_device, **kw), make_env("rigid_pushing", device="cpu", **kw)
    sg = gpu.reset(torch.Generator(device=cuda_device).manual_seed(0))
    sc = tree_to(sg, "cpu")
    action = torch.tensor([1.0, 0.2, 0.0]).expand(8, 3)
    sg, _ = gpu.step(sg, action.to(cuda_device))
    sc, _ = cpu.step(sc, action)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            sg, _ = gpu.step(sg, action.to(cuda_device, non_blocking=True))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for _ in range(2):
        sc, _ = cpu.step(sc, action)
    assert (sg.scene.bodies.pos.cpu() - sc.scene.bodies.pos).abs().max().item() <= 1e-5
    assert (sg.scene.bodies.lin_vel.cpu() - sc.scene.bodies.lin_vel).abs().max().item() <= 1e-3


# ------------------------------------------- the baseline models on the card

SMALL_MODEL = {"env": {"num_envs": 4, "kwargs": {"warmup_steps": 0}}, "algorithm": {"latent_dim": 16, "num_ori": 4, "dtype": "float32"}}


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["rigid_insertion_multi_hepi_trpl", "cloth_hanging_multi_hepi_trpl"])
@pytest.mark.parametrize("model", ["empn", "transformer", "gcn", "meshgraphnet", "mlp"])
def test_model_forward_on_the_card_matches_cpu(cuda_device, model, config):
    """Policy distribution and value of the initial observation at 4 envs in
    f32, the card against the CPU with the same params: within 1e-5 of each
    output's scale (f32 sums in another order)."""
    cfg = load_config(config, overrides={**SMALL_MODEL, "model": model})
    gpu, cpu = trainer_from_config(cfg, device=cuda_device), trainer_from_config(cfg, device="cpu")
    state = gpu.init(torch.Generator(device=cuda_device).manual_seed(0))
    cpu.policy.load_state_dict(gpu.policy.state_dict())
    cpu.critic.load_state_dict(gpu.critic.state_dict())
    from geometry_rl_torch.rl.obs_pipeline import obs_norm_apply

    tobs = obs_norm_apply(state.norm, state.obs)
    tobs_c = {k: v.cpu() for k, v in tobs.items()}
    with torch.no_grad():
        gpu._policy_dist(tobs)  # warm-up: cuBLAS handles and workspaces
        torch.cuda.synchronize()
        # the builders and every model forward (homogenize's edge-type one-hot
        # among them) issue no host synchronisation
        torch.cuda.set_sync_debug_mode("error")
        try:
            d_g, v_g = gpu._policy_dist(tobs), gpu._value(tobs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        d_c, v_c = cpu._policy_dist(tobs_c), cpu._value(tobs_c)
    for name, g, c in (("mean", d_g.mean, d_c.mean), ("std", d_g.std, d_c.std), ("value", v_g, v_c)):
        assert g.device.type == "cuda"
        assert (g.cpu() - c).abs().max().item() <= 1e-5 * max(c.abs().max().item(), 1e-3), (model, name)


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["rigid_insertion_two_agents_multi_hepi_trpl", "rigid_insertion_two_agents_multi_empn_trpl",
                                    "rigid_insertion_two_agents_multi_transformer_trpl"])
def test_new_collects_do_not_synchronise(cuda_device, config):
    """The two-gripper collect (the `agent` conv and the two-gripper builder)
    with HEPi and with the homogenized models (`graphs/homogenize.py` builds
    its edge-type one-hot on every forward) after a warm-up collect, under
    CUDA's sync debug mode set to error."""
    cfg = load_config(config, overrides={
        "env": {"num_envs": 16, "kwargs": {"warmup_steps": 0}}, "collector": {"frames_per_batch": 32},
        "algorithm": {"latent_dim": 16, "num_ori": 4},
    })
    trainer = trainer_from_config(cfg, device=cuda_device)
    state = trainer.init(torch.Generator(device=cuda_device).manual_seed(0))
    state, _, _ = trainer._collect(state)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, batch, _ = trainer._collect(state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(batch.reward).all()


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["cloth_hanging_multi_empn_trpl", "rigid_insertion_multi_transformer_trpl",
                                    "rigid_insertion_two_agents_multi_hepi_trpl"])
def test_new_train_iterations_on_the_card_are_finite(cuda_device, config):
    """A small bf16 training iteration of each new full-width configuration."""
    cfg = load_config(config, overrides={
        "env": {"num_envs": 8, "kwargs": {"warmup_steps": 1, "episode_length": 4}}, "collector": {"frames_per_batch": 32},
        "algorithm": {"objective": {"mini_batch_size": 16}},
    })
    trainer = trainer_from_config(cfg, device=cuda_device)
    state = trainer.init(torch.Generator(device=cuda_device).manual_seed(0))
    before = {k: v.clone() for k, v in trainer.policy.state_dict().items()}
    state, metrics = trainer.train_iteration(state)
    assert all(torch.isfinite(v).all() for v in metrics.values()), metrics
    assert any((trainer.policy.state_dict()[k] - v).abs().max() > 0 for k, v in before.items())


@pytest.mark.cuda
def test_cloth_collect_does_not_synchronise(cuda_device):
    """The whole cloth_hanging collect (obs normaliser, graph builders, HEPi,
    critic, action sampling, the env step with K2's port and the fresh layout
    drawn every step) through auto-resets, after a warm-up collect, under
    CUDA's sync debug mode set to error."""
    cfg = load_config("cloth_hanging_multi_hepi_trpl", overrides={
        "env": {"num_envs": 16, "kwargs": {"warmup_steps": 0, "episode_length": 3}},
        "collector": {"frames_per_batch": 128}, "algorithm": {"latent_dim": 16, "num_ori": 4},
    })
    trainer = trainer_from_config(cfg, device=cuda_device)
    state = trainer.init(torch.Generator(device=cuda_device).manual_seed(0))
    state, _, _ = trainer._collect(state)
    torch.cuda.synchronize()
    LAUNCHES.update(cloth_solve=0, cloth_solve_env=0)
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, batch, _ = trainer._collect(state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert LAUNCHES == {"cloth_solve": 2 * 8, "cloth_solve_env": 0}
    assert batch.done.any() and torch.isfinite(batch.reward).all()


PAPI = {"algorithm": {"projection": {"proj_type": "papi"}, "policy": {"contextual_std": False},
                      "objective": {"papi_steps": True, "mini_batch_size": 16}}}


@pytest.mark.cuda
@pytest.mark.parametrize("config,overrides", [
    ("rigid_insertion_multi_hepi_trpl", {"algo": "ppo"}),
    ("rigid_insertion_multi_hepi_trpl", {"algo": "kl_ppo", "algorithm": {"objective": {"kl_beta_interval": "iteration"}}}),
    ("cloth_hanging_multi_hepi_trpl", {"algorithm": {"projection": {"proj_type": "frob"}}}),
    ("cloth_hanging_multi_transformer_trpl", PAPI),
], ids=["ppo", "kl_ppo", "frob", "papi"])
def test_new_algorithms_train_on_the_card(cuda_device, config, overrides):
    """A small bf16 iteration of each new algorithm on the card: finite
    metrics, params that moved; kl_ppo's beta and PAPI's carry on the card
    and the CPU where they belong."""
    base = {"env": {"num_envs": 8, "kwargs": {"warmup_steps": 1, "episode_length": 4}}, "collector": {"frames_per_batch": 32},
            "algorithm": {"objective": {"mini_batch_size": 16}}}
    cfg = load_config(config, overrides=_merge(base, overrides))
    trainer = trainer_from_config(cfg, device=cuda_device)
    state = trainer.init(torch.Generator(device=cuda_device).manual_seed(0))
    before = {k: v.clone() for k, v in trainer.policy.state_dict().items()}
    if trainer.cfg.papi_steps:
        papi = trainer.papi_init(state)
        state, papi, metrics = trainer.train_iteration_papi(state, papi)
        assert papi.history["mean.weight"].device.type == "cuda" and papi.lr_scale.device.type == "cpu"
        assert 0.0 < metrics["papi/lr_scale"].item() <= 1.0
    else:
        state, metrics = trainer.train_iteration(state)
    assert all(torch.isfinite(v).all() for v in metrics.values()), metrics
    assert any((trainer.policy.state_dict()[k] - v).abs().max() > 0 for k, v in before.items())
    if trainer.cfg.algo == "kl_ppo":
        assert state.kl_beta.device.type == "cuda" and state.kl_beta.item() in (0.5, 1.0, 2.0)


@pytest.mark.cuda
def test_bc_epoch_and_render_frames_do_not_synchronise(cuda_device):
    """A behaviour-cloning epoch (gather, HEPi forward, MSE, backward, Adam
    over every minibatch) and `collect_frames`' rollout (K2's port in every
    step, snapshots kept on the card) under CUDA's sync debug mode set to
    error; only the host reads that end them (the epoch's loss, the frames'
    copy) synchronise."""
    from geometry_rl_torch.train.bc import bc_epoch, generate_data
    from geometry_rl_torch.train.render import collect_frames, frame_tensors

    cfg = load_config("cloth_hanging_multi_hepi_trpl", overrides={
        "env": {"num_envs": 8, "kwargs": {"warmup_steps": 0, "episode_length": 3}},
        "algorithm": {"latent_dim": 16, "num_ori": 4},
    })
    trainer = trainer_from_config(cfg, device=cuda_device)
    state = trainer.init(torch.Generator(device=cuda_device).manual_seed(0))
    data = generate_data(trainer, state, n_steps=4)
    tobs = {k[4:]: torch.tensor(v, device=cuda_device) for k, v in data.items() if k.startswith("obs_")}
    actions, ids = torch.tensor(data["action"], device=cuda_device), torch.tensor(data["env_ids"], device=cuda_device).long()
    perm = torch.randperm(32, device=cuda_device).reshape(4, 8)
    opt = torch.optim.Adam(trainer.policy.parameters(), lr=3e-4, eps=1e-8)
    bc_epoch(trainer, opt, tobs, actions, ids, perm)  # warm-up: the optimiser's state is made
    frame_tensors(trainer, state, 2)
    torch.cuda.synchronize()
    LAUNCHES.update(cloth_solve=0, cloth_solve_env=0)
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = bc_epoch(trainer, opt, tobs, actions, ids, perm)
        stacked, done = frame_tensors(trainer, state, 5)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(loss) and done.shape == (5,) and stacked["particles"].shape == (5, 225, 3)
    assert LAUNCHES == {"cloth_solve": 2 * 5, "cloth_solve_env": 0}
    assert len(collect_frames(trainer, state, 5)) == 2  # env 0 ends its episode at the third step


# ------------------------------------------------------------ the fixed-order segment sum

# each HEPi main path's config, whose update builds graphs of `mini_batch_size` samples
HEPI_CONFIGS = ["cloth_hanging_multi_hepi_trpl", "rigid_insertion_multi_hepi_trpl", "rope_closing_hepi_trpl"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("config", HEPI_CONFIGS)
def test_segment_sum_kernel_matches_plain_version(cuda_device, config, dtype):
    """Every CSR of the config's policy graph at its update's minibatch size
    (cloth and rope 200, rigid 1000: the rigid kNN CSR per env), values of
    HEPi's width (16 orientations x 64 channels): the kernel adds in the
    plain version's order, so the two are bit-equal."""
    cfg = load_config(config)
    B = cfg["algorithm"]["objective"]["mini_batch_size"]
    cfg = _merge(cfg, {"env": {"num_envs": B, "kwargs": {"warmup_steps": 0}}})
    trainer = trainer_from_config(cfg, device=cuda_device)
    env_state = trainer.env.reset(torch.Generator(device=cuda_device).manual_seed(0))
    graph, _ = trainer.policy_builder.build(obs_norm_apply(trainer.init(torch.Generator(device=cuda_device).manual_seed(0)).norm,
                                                           trainer.env.observe(env_state)))
    g = torch.Generator(device=cuda_device).manual_seed(1)
    for ek, es in graph.edges.items():
        for csr in (es.dst_csr, es.src_csr):
            values = torch.randn((B, es.num_edges, 16 * 64), generator=g, device=cuda_device).to(dtype)
            before = SEGMENT_LAUNCHES["segment_sum"]
            got = segment_sum_cuda(values, csr)
            assert SEGMENT_LAUNCHES["segment_sum"] == before + 1
            torch.cuda.synchronize()
            assert torch.equal(got, segment_sum_ref(values, csr)), (ek, dtype)


@pytest.mark.cuda
def test_message_sums_launch_the_kernel(cuda_device):
    """On CUDA tensors scatter_sum's forward and gather_nodes' backward each
    launch the kernel once, and match the same sums on the CPU (the plain
    version) bit for bit."""
    idx = torch.tensor([[0, 3, 3, 1, 3], [2, 2, 0, 0, 4]])
    csr = csr_from_index(idx, 5)
    msg = torch.randn(2, 5, 4, 8)
    x = torch.randn(2, 5, 4, 8)
    outs = {}
    for dev in ("cpu", "cuda"):
        SEGMENT_LAUNCHES["segment_sum"] = 0
        m, v = msg.to(dev, copy=True).requires_grad_(), x.to(dev, copy=True).requires_grad_()
        c = type(csr)(*(t.to(dev) for t in csr))
        out = scatter_sum(m, idx.to(dev), 5, c)
        gathered = gather_nodes(v, idx.to(dev), c)
        (out.sum() + (gathered * gathered).sum()).backward()
        outs[dev] = (out.detach().cpu(), v.grad.cpu(), m.grad.cpu())
        assert SEGMENT_LAUNCHES["segment_sum"] == (2 if dev == "cuda" else 0)
    for a, b in zip(outs["cpu"], outs["cuda"]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_segment_sum_rejects_bad_operands(cuda_device):
    csr = csr_from_index(torch.tensor([[0, 1, 1]], device=cuda_device), 2)
    values = torch.randn(2, 3, 4, device=cuda_device)
    for bad_values, bad_csr, err in (
        (values.half(), csr, TypeError),  # neither f32 nor bf16
        (values.transpose(0, 1), csr, ValueError),  # not contiguous
        (values.cpu(), csr, ValueError),  # not on the card
        (values, type(csr)(csr.perm.long(), csr.offsets), TypeError),  # perm not int32
        (values, type(csr)(csr.perm, csr.offsets.expand(2, -1).contiguous()), ValueError),  # offsets per env, perm shared
        (values[:, :2].contiguous(), csr, ValueError),  # perm of another edge count
    ):
        with pytest.raises(err):
            segment_sum_cuda(bad_values, bad_csr)


@pytest.mark.cuda
@pytest.mark.parametrize("config", HEPI_CONFIGS + ["cloth_hanging_multi_empn_trpl", "rigid_pushing_multi_hepi_trpl"])
def test_collect_and_update_give_the_same_bits_twice(cuda_device, config):
    """A 4-env collect plus `_update`, twice from one seed, without PyTorch's
    deterministic algorithms: every param, Adam state, metric and env state
    tensor equal (NaN equal to NaN). rigid_pushing with
    dynamic_friction_scale 1.0 runs the XPBD velocity pass."""
    overrides = {"env": {"num_envs": 4, "kwargs": {"warmup_steps": 1}}, "collector": {"frames_per_batch": 24},
                 "algorithm": {"latent_dim": 16, "num_ori": 4, "objective": {"mini_batch_size": 8}}}
    if config.startswith("rigid_pushing"):
        overrides["env"]["kwargs"]["dynamic_friction_scale"] = 1.0
    cfg = load_config(config, overrides=overrides)

    def run():
        ON_THE_SPOT["csr"] = 0
        trainer = trainer_from_config(cfg, device=cuda_device)
        state = trainer.init(torch.Generator(device=cuda_device).manual_seed(0))
        state, batch, stats = trainer._collect(state)
        state, metrics = trainer._update(state, batch)
        assert ON_THE_SPOT["csr"] == 0
        out = {**{f"m {k}": v for k, v in {**stats, **metrics}.items()},
               **{f"p {k}": v for k, v in trainer.policy.state_dict().items()},
               **{f"c {k}": v for k, v in trainer.critic.state_dict().items()}}
        for opt in ("actor_opt", "critic_opt"):
            for i, entry in getattr(state, opt).state_dict()["state"].items():
                out.update({f"{opt} {i} {k}": v for k, v in entry.items()})
        leaves = [t for t in torch.utils._pytree.tree_leaves(state.env_state) if torch.is_tensor(t)]
        out.update({f"env {i}": t for i, t in enumerate(leaves)})
        return out

    first, second = run(), run()
    assert first.keys() == second.keys()
    for k, a in first.items():
        b = second[k]
        same = ((a == b) | (torch.isnan(a) & torch.isnan(b))).all() if a.is_floating_point() else torch.equal(a, b)
        assert same, k


@pytest.mark.cuda
def test_xpbd_spec_without_sum_order_raises_on_card(cuda_device):
    """A joint or attachment spec without its fixed sum order would have one
    made from its index, read on the host, in every substep: on the card the
    solver raises instead, and with the order made once it runs."""
    from geometry_rl_torch.sim import xpbd
    from geometry_rl_torch.sim.types import FixedJointSpec, RigidBodySpec

    NB, NP, dev = 3, 4, cuda_device
    ones = torch.ones(NB, device=dev)
    spec = RigidBodySpec(inv_mass=ones, inv_inertia=torch.ones(NB, 3, device=dev), gravity_scale=0 * ones,
                         lin_damping=ones, ang_damping=ones, free_pos=torch.ones(NB, 3, device=dev),
                         free_rot=torch.ones(NB, 3, device=dev))
    pos, quat = torch.randn(2, NB, 3, device=dev), torch.tensor([1.0, 0, 0, 0], device=dev).expand(2, NB, 4)
    joints = FixedJointSpec(body_a=torch.tensor([0, 1], device=dev), body_b=torch.tensor([2, 2], device=dev),
                            local_pos_a=torch.zeros(2, 3, device=dev), local_pos_b=torch.zeros(2, 3, device=dev),
                            rel_quat=torch.tensor([[1.0, 0, 0, 0]] * 2, device=dev))
    att = xpbd.BodyAttachment(particle=torch.tensor([0, 3], device=dev), body=torch.tensor([1, 1], device=dev),
                              local_pos=torch.zeros(2, 3, device=dev))
    x, inv_mass = torch.randn(2, NP, 3, device=dev), torch.ones(NP, device=dev)
    with pytest.raises(ValueError, match="joint_sum_order"):
        xpbd._solve_fixed_joints(pos, quat, spec, joints)
    with pytest.raises(ValueError, match="attachment_sum_order"):
        xpbd._solve_attachments(x, inv_mass, pos, quat, spec, att)
    xpbd._solve_fixed_joints(pos, quat, spec, xpbd.joint_sum_order(joints, NB))
    xpbd._solve_attachments(x, inv_mass, pos, quat, spec, xpbd.attachment_sum_order(att, NP, NB))
