"""The port's benchmark entry points (`geometry_rl_torch/tools/bench.py`,
`bench_all.py`) on the CPU at tiny sizes, against `bench.py` and
`scripts/bench_all.py`.

- `tools.bench --tiny --device cpu` prints one JSON line with the metric,
  unit and keys `tests/test_bench_smoke.py` asserts for `bench.py`, and no
  `mfu` (the CPU has no peak in the table); its sizes are bench.py's;
- one step of the timed collection loop against bench.py's loop body
  (`bench.py:86-88`) at 4 envs in f32, from the same env state with the Flax
  params carried across: the normalised observation, the policy's mean and
  its std within RTOL = 1e-4 of each quantity's scale (the tolerance of
  tests/test_torch_rigid_slice.py's rollout; the two agree to ~1e-6). The
  action's draw differs (threefry against Philox) and is not compared;
- the FLOP count against hand counts (2·M·N·K per product) of one Dense
  layer and one `FiberBundleConv`;
- `tools.bench_all`: two rows at a tiny size with positive rates, without
  touching the JAX package's `docs/bench_all.json`; a failing row is
  recorded and the exit code is 1;
- both tools default to `--device cuda` and raise where there is no card.
"""

import hashlib
import json
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import test_torch_common  # noqa: E402,F401  (pins torch to one thread per test worker)
from test_torch_common import close, np_tree  # noqa: E402

from geometry_rl_tpu.rl.obs_pipeline import obs_norm_init as jax_obs_norm_init  # noqa: E402
from geometry_rl_tpu.rl.obs_pipeline import obs_norm_step as jax_obs_norm_step  # noqa: E402
from geometry_rl_tpu.train import TrainConfig as JaxTrainConfig  # noqa: E402
from geometry_rl_tpu.train.builders import build_agent as jax_build_agent  # noqa: E402
from geometry_rl_torch.convert import params_from_flax, rigid_state_from_jax  # noqa: E402
from geometry_rl_torch.models.common import Dense  # noqa: E402
from geometry_rl_torch.models.ponita import FiberBundleConv  # noqa: E402
from geometry_rl_torch.rl.obs_pipeline import obs_norm_init  # noqa: E402
from geometry_rl_torch.tools import bench, bench_all  # noqa: E402
from geometry_rl_torch.train import TrainConfig  # noqa: E402
from geometry_rl_torch.train.builders import build_agent  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-4


def test_bench_tiny_prints_the_contract_line(capsys):
    bench.main(["--tiny", "--device", "cpu"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == "rigid_insertion_hepi_collection_env_steps_per_sec"
    assert rec["value"] > 0 and rec["unit"] == "env-steps/sec"
    assert "vs_baseline" in rec and rec["vs_baseline"] is None
    extra = rec["extra"]
    assert extra["cloth_hanging_collection_env_steps_per_sec"] > 0
    iteration = extra["rigid_insertion_train_iteration"]
    for key in ("iteration_s", "frames_per_sec", "collect_s", "update_s"):
        assert iteration[key] > 0, key
    assert iteration["collect_s"] + iteration["update_s"] <= iteration["iteration_s"] * 1.01
    # no peak for the CPU: no MFU, as bench.py leaves it out for a device it has no peak for
    assert "mfu" not in iteration and "flops_per_iter" not in iteration
    assert extra["device_kind"] == "cpu" and extra["n_devices"] == 1
    assert extra["baseline"] == "none set for the card" and "power_limit_w" not in extra


@pytest.mark.parametrize("argv, env, want", [
    ([], None, bench.FULL),
    (["--tiny"], None, bench.TINY),
    ([], "1", bench.TINY),
    (["--steps", "4", "--runs", "1"], None, {**bench.FULL, "collection_steps": 4, "iteration_steps": 4,
                                            "collection_runs": 1, "iteration_runs": 1}),
])
def test_bench_takes_bench_py_sizes(monkeypatch, capsys, argv, env, want):
    """bench.py's sizes (`bench.py:281-287`, `:73-74`), its tiny ones under
    --tiny or GEOMRL_BENCH_TINY=1, and a cut depth at full width."""
    calls = []
    monkeypatch.setattr(bench, "bench_collection", lambda *a, **kw: calls.append(("collect", a, kw)) or 1.0)
    monkeypatch.setattr(bench, "bench_train_iteration", lambda **kw: calls.append(("iteration", (), kw)) or {})
    if env is None:
        monkeypatch.delenv("GEOMRL_BENCH_TINY", raising=False)
    else:
        monkeypatch.setenv("GEOMRL_BENCH_TINY", env)
    assert {"rigid_envs": 1024, "cloth_envs": 256, "iteration_envs": 1024, "collection_steps": 50,
            "iteration_steps": 100, "latent_dim": 64, "num_ori": 16}.items() <= bench.FULL.items()
    bench.main(argv + ["--device", "cpu"])
    widths = {"latent_dim": want["latent_dim"], "num_ori": want["num_ori"]}
    assert [c[1] for c in calls[:2]] == [
        ("rigid_insertion", want["rigid_envs"], want["collection_steps"], want["collection_runs"]),
        ("cloth_hanging", want["cloth_envs"], want["collection_steps"], want["collection_runs"]),
    ]
    assert all(c[2].items() >= widths.items() for c in calls)
    assert calls[2][2].items() >= {"num_envs": want["iteration_envs"], "steps": want["iteration_steps"],
                                   "n_runs": want["iteration_runs"]}.items()
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["extra"]["sizes"] == want


def test_collection_step_matches_the_jax_bench_loop():
    """bench.py's loop body (`bench.py:86-88`: the normaliser's update, the
    graph, the policy) and the port's `act` from the same state and params,
    then the port's whole step (the sample and env.step) runs."""
    kw = dict(num_envs=4, latent_dim=16, num_ori=4, env_kwargs={"warmup_steps": 0})
    jtr = jax_build_agent("rigid_insertion", "hepi", train_cfg=JaxTrainConfig(steps_per_batch=2, mini_batch_size=8), **kw)
    key = jax.random.PRNGKey(0)
    j_env = jax.jit(jtr.env.reset)(key)
    j_obs = jax.jit(jtr.env.observe)(j_env)
    j_norm = jax_obs_norm_init(jtr.env.obs_spec.group_dim("scalars"))
    _, tobs0 = jax_obs_norm_step(j_norm, j_obs, update=False)
    params = jax.jit(lambda k, tobs: jtr.policy.init(k, *jtr.policy_builder.build(tobs)))(key, tobs0)

    @jax.jit
    def j_act(norm, obs):
        norm, tobs = jax_obs_norm_step(norm, obs, update=True)
        return norm, tobs, jtr.policy.apply(params, *jtr.policy_builder.build(tobs))

    j_norm, j_tobs, j_dist = j_act(j_norm, j_obs)

    ttr = build_agent("rigid_insertion", "hepi", train_cfg=TrainConfig(steps_per_batch=2, mini_batch_size=8),
                      device="cpu", **kw)
    ttr.policy.load_state_dict(params_from_flax(np_tree(params)))
    t_env = rigid_state_from_jax(np_tree(j_env), torch.Generator().manual_seed(0))
    t_obs = ttr.env.observe(t_env)
    t_norm = obs_norm_init(ttr.env.obs_spec.group_dim("scalars"), "cpu")
    t_norm, t_tobs, t_dist = bench.act(ttr, t_norm, t_obs)

    assert sorted(t_tobs) == sorted(j_tobs)
    for k, v in t_tobs.items():
        assert close(v, j_tobs[k], RTOL), k
    for name in ("mean", "std"):
        assert getattr(t_dist, name).shape == getattr(j_dist, name).shape
        assert close(getattr(t_dist, name), getattr(j_dist, name), RTOL), name
    t_leaves, j_leaves = jax.tree_util.tree_leaves(tuple(t_norm)), jax.tree_util.tree_leaves(np_tree(j_norm))
    assert len(t_leaves) == len(j_leaves)
    for got, ref in zip(t_leaves, j_leaves):
        assert close(got, ref, RTOL)

    fresh = obs_norm_init(ttr.env.obs_spec.group_dim("scalars"), "cpu")
    (_, obs, _), reward = bench.collection_step(ttr, (t_env, t_obs, fresh), torch.Generator().manual_seed(0))
    assert reward.shape == (4,) and torch.isfinite(reward).all()
    assert all(torch.isfinite(v).all() for v in obs.values() if v.is_floating_point())


def test_flop_count_matches_hand_counts():
    """2·M·N·K per matrix product: a Dense layer, and a FiberBundleConv's
    kernel and fiber-kernel Dense layers, its depthwise fiber contraction
    (a batched product over channels) and its two MLP layers."""
    g = torch.Generator().manual_seed(0)
    N, K, M = 5, 6, 7
    flops, _ = bench.count_flops(Dense(K, M), torch.randn(N, K, generator=g))
    assert flops == 2 * N * K * M

    B, Ns, Nd, E, O, C, A = 2, 5, 3, 7, 4, 8, 6
    conv = FiberBundleConv(C, A)
    args = (torch.randn(B, Ns, O, C, generator=g), torch.randn(B, Nd, O, C, generator=g),
            torch.randint(0, Ns, (B, E), generator=g), torch.randint(0, Nd, (B, E), generator=g),
            torch.ones(B, E, dtype=torch.bool), torch.randn(B, E, O, A, generator=g), torch.randn(O, O, A, generator=g))
    flops, _ = bench.count_flops(conv, *args)
    kernel = 2 * (B * E * O) * A * C
    fiber_kernel = 2 * (O * O) * A * C
    fiber_conv = 2 * C * (B * Nd) * O * O
    mlp = 2 * (2 * (B * Nd * O) * C * 4 * C)
    assert flops == kernel + fiber_kernel + fiber_conv + mlp


def sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_bench_all_tiny_rows(tmp_path, capsys):
    record = os.path.join(REPO, "docs", "bench_all.json")
    before = sha(record)
    out = tmp_path / "table.json"
    rc = bench_all.main(["--tiny", "--device", "cpu", "--tasks", "rigid_insertion", "cloth_hanging_pallas",
                         "--steps", "2", "--out", str(out)])
    assert rc == 0
    table = json.loads(out.read_text())
    assert list(table) == ["rigid_insertion", "cloth_hanging_pallas"]
    for row in table.values():
        assert row["num_envs"] == bench_all.TINY["num_envs"]
        assert row["env_only_steps_per_s"] > 0 and row["collection_steps_per_s"] > 0
    assert sha(record) == before
    assert "wrote" in capsys.readouterr().out


def test_bench_all_records_a_failing_row_and_exits_non_zero(tmp_path, monkeypatch):
    monkeypatch.setattr(bench_all, "TASKS", [("no_such_task", 4, {}), *bench_all.TASKS])
    out = tmp_path / "table.json"
    rc = bench_all.main(["--tiny", "--device", "cpu", "--tasks", "no_such_task", "rope_shaping", "--steps", "1",
                         "--out", str(out)])
    table = json.loads(out.read_text())
    assert rc == 1
    assert list(table["no_such_task"]) == ["error"]
    assert table["no_such_task"]["error"].startswith("ValueError: Unknown task 'no_such_task'")
    assert table["rope_shaping"]["env_only_steps_per_s"] > 0  # the table went on past the failure


@pytest.mark.parametrize("tool", [bench, bench_all])
def test_device_defaults_to_cuda_and_raises_without_a_card(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cuda"):
        tool.main([])
