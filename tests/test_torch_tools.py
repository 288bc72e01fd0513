"""The port's evaluation tools (`geometry_rl_torch/tools/`) against the JAX
package's scripts, on the CPU at a tiny size.

- `breakdown` against a numpy restatement of `scripts/eval_breakdown.py`'s
  report (exact);
- `tools.eval_breakdown` end to end on a tiny rigid_insertion run (4 envs,
  episode length 8) against the JAX script's rollout from the same reset
  state with the Flax params and the normaliser carried across: per-shape
  final distances within tests/test_torch_rigid_slice.py's tolerance (1e-4
  of scale);
- `tools.learn_check` for 2 iterations at 4 envs: its row and `SUMMARY` keys
  are the JAX script's (read from `scripts/learn_check.py`);
- `tools.smoke_env` on all 7 tasks at 2 envs and 2 steps;
- `tools.learning_gates`: the bands it derives from `docs/runs/`, and a tiny
  run through the CLI.
"""

import ast
import functools
import json
import os

import jax
import numpy as np
import pytest
import torch
import test_torch_common  # noqa: F401  (pins torch to one thread per test worker)
from test_torch_common import frozen, np_tree, reference_agent

from geometry_rl_tpu.rl.obs_pipeline import obs_norm_step as jax_obs_norm_step, obs_norm_update
from geometry_rl_torch.config import load_config, trainer_from_config
from geometry_rl_torch.convert import obs_norm_from_jax, params_from_flax, rigid_state_from_jax
from geometry_rl_torch.envs import rigid as rigid_envs
from geometry_rl_torch.tools import eval_breakdown, learn_check, learning_gates, smoke_env
from geometry_rl_torch.train.checkpoint import save_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-4
EPISODE = 8
TINY = {"env": {"num_envs": 4, "kwargs": {"warmup_steps": 0, "episode_length": EPISODE}},
        "collector": {"frames_per_batch": 32},
        "algorithm": {"latent_dim": 16, "num_ori": 4, "dtype": "float32", "objective": {"mini_batch_size": 16}}}


def reference_breakdown(dones, dists, shape_ids, names, threshold):
    """`scripts/eval_breakdown.py`'s report, restated."""
    report = {}
    final_d = dists[dones.astype(bool)]
    if shape_ids is not None:
        final_shape = np.broadcast_to(shape_ids, dones.shape)[dones.astype(bool)]
        for s, name in enumerate(names):
            sel = final_shape == s
            if sel.sum() == 0:
                continue
            d = final_d[sel]
            report[name] = {
                "episodes": int(sel.sum()),
                "mean_final_distance": round(float(d.mean()), 4),
                "success_rate": round(float((d < threshold).mean()), 4),
            }
    overall = {
        "episodes": int(dones.sum()),
        "mean_final_distance": round(float(final_d.mean()), 4),
        "success_rate": round(float((final_d < threshold).mean()), 4),
    }
    return {"overall": overall, "per_shape": report}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_breakdown_matches_the_scripts_report(seed):
    rng = np.random.default_rng(seed)
    T, B, names = 30, 12, ("a", "b", "c", "d", "e")
    dones = rng.random((T, B)) < 0.15
    dists = rng.uniform(0.0, 0.3, (T, B)).astype(np.float32)
    shape_ids = rng.integers(0, 4, B)  # shape "e" never appears: left out
    dones[-1, 0] = True
    for ids in (shape_ids, None):
        got = eval_breakdown.breakdown(dones, dists, ids, names if ids is not None else (), 0.1)
        assert got == reference_breakdown(dones, dists, ids, names, 0.1)
    assert "e" not in got and json.dumps(got)


@functools.lru_cache(maxsize=None)
def jax_rollout():
    """(JAX trainer, state with the normaliser folded once, reset state,
    dones, distances) of the JAX script's deterministic rollout over one
    episode."""
    jtr, js = reference_agent("rigid_insertion", "hepi", frozen(num_envs=4, latent_dim=16, num_ori=4,
                                                                env_kwargs={"warmup_steps": 0, "episode_length": EPISODE}))
    js = js._replace(norm=obs_norm_update(js.norm, js.obs))
    env0 = jax.jit(jtr.env.reset)(jax.random.PRNGKey(eval_breakdown.ROLLOUT_SEED))
    j_policy, j_step = jax.jit(jtr._policy_dist), jax.jit(jtr.env.step)
    env_state, obs = env0, jax.jit(jtr.env.observe)(env0)
    dones, dists = [], []
    for _ in range(EPISODE):
        _, tobs = jax_obs_norm_step(js.norm, obs, update=False)
        env_state, ts = j_step(env_state, j_policy(js.actor_params, tobs).mean)
        dones.append(np.asarray(ts.done))
        dists.append(np.asarray(ts.info["object_target_distance"]))
        obs = ts.obs
    return jtr, js, env0, np.stack(dones), np.stack(dists)


def test_eval_breakdown_matches_the_jax_rollout(tmp_path, monkeypatch):
    jtr, js, env0, j_dones, j_dists = jax_rollout()
    cfg = load_config("rigid_insertion_multi_hepi_trpl", TINY)
    run = tmp_path / "run"
    run.mkdir()
    (run / "hparams.json").write_text(json.dumps(cfg))
    ttr = trainer_from_config(cfg, device="cpu")
    state = ttr.init(torch.Generator().manual_seed(0))
    ttr.policy.load_state_dict(params_from_flax(np_tree(js.actor_params)))
    ttr.critic.load_state_dict(params_from_flax(np_tree(js.critic_params)))
    save_checkpoint(str(run / "best"), 3, ttr, state._replace(norm=obs_norm_from_jax(np_tree(js.norm))))

    t_env0 = rigid_state_from_jax(np_tree(env0), torch.Generator().manual_seed(0))
    monkeypatch.setattr(rigid_envs.RigidEnv, "reset", lambda self, generator: t_env0)
    report = eval_breakdown.main(["--run-dir", str(run), "--episodes", "1", "--save-distances", "--device", "cpu"])

    names = jtr.env.shape_set.names
    shape_ids = np.asarray(jtr.env.shape_ids)
    ref = reference_breakdown(j_dones, j_dists, shape_ids, names, 0.1)
    assert j_dones[-1].all() and not j_dones[:-1].any()  # each env's one episode ends at the last step
    assert sorted(report["per_shape"]) == sorted(ref["per_shape"]) and len(ref["per_shape"]) == 4
    scale = max(1.0, np.abs(j_dists).max())
    for name, r in ref["per_shape"].items():
        got = report["per_shape"][name]
        assert got["episodes"] == r["episodes"] and got["success_rate"] == r["success_rate"]
        assert abs(got["mean_final_distance"] - r["mean_final_distance"]) <= RTOL * scale + 1e-4  # + the 4-place rounding
    payload = json.loads((run / "eval_breakdown.json").read_text())
    final = j_dists[j_dones.astype(bool)]
    assert payload["final_shapes"] == [names[int(s)] for s in np.broadcast_to(shape_ids, j_dones.shape)[j_dones]]
    np.testing.assert_allclose(payload["final_distances"], final, rtol=0, atol=RTOL * scale + 1e-5)
    assert payload["overall"] == report["overall"] and report["overall"]["episodes"] == 4


def _script_keys():
    """(row keys, the row's optional metric keys, SUMMARY keys) of
    `scripts/learn_check.py`, read from its source."""
    tree = ast.parse(open(os.path.join(REPO, "scripts", "learn_check.py")).read())
    row = optional = summary = None
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and any(isinstance(k, ast.Constant) and k.value == "iter" for k in node.keys):
            row = [k.value for k in node.keys if k is not None]
            optional = next(n.elts for n in ast.walk(node) if isinstance(n, ast.Tuple))
            optional = [e.value for e in optional]
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "summary":
            summary = [k.value for k in node.value.keys]
        if isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name) and node.value.id == "summary" \
                and isinstance(node.slice, ast.Constant) and node.slice.value.startswith("eval_") \
                and node.slice.value != "eval_error":
            summary.append(node.slice.value)
    return row, optional, summary


def test_learn_check_rows_and_summary_have_the_scripts_keys(tmp_path, monkeypatch, capsys):
    # an 8-step episode so that the rows' rewards and the final eval are short
    monkeypatch.setitem(rigid_envs.TASK_REGISTRY, "rigid_insertion",
                        functools.partial(rigid_envs.rigid_insertion_cfg, episode_length=EPISODE))
    out = tmp_path / "lc.json"
    history, summary = learn_check.main(["--device", "cpu", "--num-envs", "4", "--iterations", "2", "--steps-per-batch",
                                         str(EPISODE), "--mini-batch", "16", "--out", str(out),
                                         "--save-dir", str(tmp_path / "ckpt")])
    lines = capsys.readouterr().out.splitlines()
    rows = [json.loads(line) for line in lines if line.startswith("{")]
    row_keys, optional, summary_keys = _script_keys()
    # TRPL reports kl, ESS, entropy and loss_critic (the JAX runs' metrics.jsonl), no beta
    present = [k for k in optional if k in ("kl", "ESS", "entropy", "loss_critic")]
    assert len(rows) == 2 and [r["iter"] for r in rows] == [0, 1]
    for r in rows:
        assert list(r) == ["iter", "reward", *present, *[k for k in row_keys if k not in ("iter", "reward")]]
        assert all(np.isfinite(v) for v in r.values())
    (line,) = [line for line in lines if line.startswith("SUMMARY ")]
    assert list(json.loads(line[len("SUMMARY "):])) == summary_keys == list(summary)
    assert json.loads(out.read_text())["history"] == pytest.approx(history)
    assert 0.0 <= summary["eval_success_rate"] <= 1.0 and os.path.isdir(tmp_path / "ckpt" / "2")


@pytest.mark.parametrize("task", smoke_env.TASKS)
def test_smoke_env_runs_every_task(task, capsys):
    env, state, ts = smoke_env.main(["--task", task, "--num-envs", "2", "--steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"task={task} num_envs=2 action_dim={env.cfg.action_dim}" and out[-1] == "OK"
    assert [line.split(":")[0] for line in out if line.startswith("step ")] == ["step 0", "step 1"]
    assert all(line.endswith("obs finite True") for line in out if line.startswith("step "))
    assert sum(1 for line in out if line.startswith("  ")) == len(env.obs_spec.names)
    assert ts.reward.shape == (2,) and all(torch.isfinite(v).all() for v in ts.obs.values())
    assert len(smoke_env.TASKS) == 7


def test_learning_gates_hold_the_recorded_runs_bands():
    """The gates `tools.learning_gates` derives from `docs/runs/`: rigid_insertion's
    level band [-131.7, -82.7] and gain floor 38.4 over its three runs,
    rope_closing's gain floor 157.2 over its one (no level band)."""
    def derived(case):
        refs = [learning_gates.curve_stats(learning_gates.read_metrics(
            os.path.join(learning_gates.RUNS_DIR, r, "metrics.jsonl")), 10) for r in learning_gates.CASES[case].runs]
        return refs, learning_gates.gates({"last_mean": -100.0, "gain": 60.0}, refs)

    refs, g = derived("rigid_insertion")
    assert [round(r["step0"], 1) for r in refs] == [-221.5, -182.2, -184.5]
    assert [round(r["last_mean"], 1) for r in refs] == [-115.4, -105.4, -99.1]
    assert [round(b, 1) for b in g["level"]["band"]] == [-131.7, -82.7] and round(g["gain"]["min"], 1) == 38.4
    assert g["level"]["ok"] and g["gain"]["ok"]
    assert not learning_gates.gates({"last_mean": -140.0, "gain": 30.0}, refs)["level"]["ok"]
    assert not learning_gates.gates({"last_mean": -140.0, "gain": 30.0}, refs)["gain"]["ok"]
    refs, g = derived("rope_closing")
    assert round(refs[0]["step0"], 1) == -604.6 and round(refs[0]["last_mean"], 1) == -290.2
    assert round(g["gain"]["min"], 1) == 157.2 and "level" not in g


def test_learning_gates_run_the_cli(tmp_path, monkeypatch, capsys):
    """The tool end to end at a tiny size (3 iterations of a small rope): it
    trains through the CLI, reads the run's metrics.jsonl, makes the
    untrained policy's first collect again with the run's own result, and
    writes its report beside them."""
    tiny = ("env.num_envs=2", "env.kwargs.num_links=10", "env.kwargs.rope_length=1.25", "env.kwargs.episode_length=4",
            "collector.frames_per_batch=8", "algorithm.latent_dim=8", "algorithm.num_ori=4",
            "algorithm.objective.mini_batch_size=4")
    monkeypatch.setattr(learning_gates, "ITERATIONS", 3)
    monkeypatch.setitem(learning_gates.CASES, "rope_closing", learning_gates.CASES["rope_closing"]._replace(overrides=tiny))
    rc = learning_gates.main(["rope_closing", "--device", "cpu", "--log-dir", str(tmp_path)])
    (run,) = tmp_path.iterdir()
    report = json.loads((run / "learning_gates.json").read_text())
    rows = learning_gates.read_metrics(str(run / "metrics.jsonl"))
    assert sorted(rows) == [0, 1, 2] and report["port"] == learning_gates.curve_stats(rows, 3)
    assert rc == (0 if all(g["ok"] for g in report["gates"].values()) else 1)
    assert list(report["refs"]) == ["r8_rope_closing"] and "LEARNING " in capsys.readouterr().out
    step0 = report["step0_collect"]
    assert step0["train/reward"] == pytest.approx(rows[0]["train/reward"], rel=1e-6)
    assert step0["step_reward_mean"] == pytest.approx(rows[0]["train/reward"] / 4, rel=1e-5)
    assert np.isfinite(step0["policy_mean_abs"]) and step0["policy_mean_abs"] > 0
