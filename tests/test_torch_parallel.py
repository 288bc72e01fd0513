"""Env-axis data parallelism of the port (`parallel/mesh.py`,
`parallel/multihost.py`, the trainer's collectives): semantically a no-op,
as `tests/test_parallel.py` and `tests/test_multihost.py` hold it for the
JAX package.

- In process: a rank's env is the row block of the one-process env, its
  generator never split (it advances as the one-process generator does),
  `shard_env_state` places row blocks, and the normaliser's all-reduced fold
  equals the one-process fold (a stand-in for the collective sums the other
  rank's share).
- Two gloo processes x 4 envs against one process x 8 envs of
  `tests/test_multihost.py`'s configuration through the port's CLI:
  metrics within 1e-4 + 1e-3 |a| and final params within atol 5e-5, rtol
  1e-4 (`tests/test_parallel.py`'s tolerances), the env's float state within
  1e-5. In f32: the YAML's bf16 rounds where the batch size picks the
  kernels' blocking, a different program at each width. The 2-rank
  checkpoint holds the whole env state and restores in one process.
"""

import collections
import glob
import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch
import test_torch_common  # noqa: F401  (pins torch to one thread per test worker)
from test_torch_common import SUBPROCESS_THREADS

from geometry_rl_torch.envs import make_env
from geometry_rl_torch.graphs.rigid import noise_like
from geometry_rl_torch.parallel.mesh import RowGenerator, Rows, env_rows, shard_env_state, shard_train_state
from geometry_rl_torch.rl.normalizer import vecnorm_init, vecnorm_update

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_OVERRIDES = [  # tests/test_multihost.py's, in f32
    "seed=0", "env.num_envs=8", "env.kwargs.warmup_steps=0", "env.kwargs.episode_length=8",
    "collector.frames_per_batch=64", "collector.total_frames=128", "algorithm.latent_dim=16", "algorithm.num_ori=4",
    "algorithm.objective.mini_batch_size=32", "algorithm.dtype=float32", "logger.checkpoint.save_interval=1",
]
TIMING = {"wall_time", "train/iteration_time", "train/collect_time", "train/update_time"}


def test_rank_env_is_the_row_block_and_its_generator_is_never_split():
    for task, kw in (("rigid_insertion", {"warmup_steps": 1}), ("cloth_hanging", {"warmup_steps": 1}),
                     ("rope_closing", {"num_links": 10, "rope_length": 1.25, "warmup_steps": 1})):
        full = make_env(task, num_envs=4, device="cpu", **kw)
        rank1 = make_env(task, num_envs=2, device="cpu", rows=env_rows(4, 1, 2), **kw)
        s_full, s_1 = full.reset(torch.Generator().manual_seed(3)), rank1.reset(torch.Generator().manual_seed(3))
        action = torch.randn((4, full.cfg.action_dim), generator=torch.Generator().manual_seed(4))
        for _ in range(2):  # through the fresh layouts drawn every step
            s_full, ts_full = full.step(s_full, action)
            s_1, ts_1 = rank1.step(s_1, action[2:])
        assert torch.equal(s_1.scene.bodies.pos, s_full.scene.bodies.pos[2:]), task
        assert torch.equal(ts_1.obs["scalars"], ts_full.obs["scalars"][2:]), task
        assert torch.equal(s_1.generator.get_state(), s_full.generator.get_state()), task


def test_shard_env_state_places_row_blocks():
    env = make_env("rigid_insertion", num_envs=4, device="cpu", warmup_steps=0)
    state = env.reset(torch.Generator().manual_seed(0))
    obs = env.observe(state)
    for rank in range(2):
        rows = env_rows(4, rank, 2)
        part = shard_env_state(state, rows, 4)
        assert torch.equal(part.scene.bodies.pos, state.scene.bodies.pos[2 * rank : 2 * rank + 2])
        assert part.generator is state.generator  # replicated, never split
        assert shard_env_state(obs, rows, 4)["scalars"].shape[0] == 2

    State = collections.namedtuple("State", ["env_state", "obs", "num_updates"])
    placed = shard_train_state(State(state, obs, 0), env_rows(4, 1, 2), 4)
    assert placed.num_updates == 0 and torch.equal(placed.obs["scalars"], obs["scalars"][2:])
    assert torch.equal(placed.env_state.prev_action, state.prev_action[2:])
    try:
        env_rows(6, 0, 4)
    except ValueError as e:
        assert "not divisible" in str(e)
    else:
        raise AssertionError("an indivisible env axis was split")


def test_training_noise_of_a_rank_is_its_rows_of_the_global_draw():
    """Under data parallelism a rank's training noise is its samples' rows of
    the noise one process draws for the whole minibatch."""
    x = torch.zeros((6, 5, 3))
    whole = noise_like(x, torch.Generator().manual_seed(7), 0.01)
    rows = torch.tensor([1, 4, 5])
    mine = noise_like(x[rows], RowGenerator(torch.Generator().manual_seed(7), Rows(rows, 6)), 0.01)
    assert torch.equal(mine, whole[rows])


def test_normaliser_all_reduced_fold_equals_one_process_fold():
    x = torch.randn((8, 5, 3), generator=torch.Generator().manual_seed(1)) * 3.0 + 1.0
    state = vecnorm_update(vecnorm_init((3,)), torch.randn((8, 5, 3), generator=torch.Generator().manual_seed(2)))
    one = vecnorm_update(state, x)

    class OtherRank:  # the collective, with the other rank's share of the batch
        world = 2

        def all_reduce(self, tensors):
            other = x[4:]
            return [tensors[0] + other.sum(dim=(0, 1)), tensors[1] + (other * other).sum(dim=(0, 1))]

    two = vecnorm_update(state, x[:4], dp=OtherRank())
    assert two.count == one.count
    torch.testing.assert_close(two.sum, one.sum, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(two.ssq, one.ssq, rtol=1e-6, atol=1e-5)


def test_a_single_process_joins_no_group(monkeypatch):
    """Without a launch's variables no process group is made; the process is
    rank 0, and its device is the one asked for."""
    from geometry_rl_torch.parallel import is_main_process, local_device, maybe_initialize_distributed

    for var in ("GEOMRL_COORDINATOR", "GEOMRL_MULTIHOST"):
        monkeypatch.delenv(var, raising=False)
    assert maybe_initialize_distributed("cpu") is False and not torch.distributed.is_initialized()
    assert is_main_process() and local_device("cpu") == torch.device("cpu")


def test_an_env_launch_joins_a_group_and_its_collectives_run(monkeypatch):
    """GEOMRL_MULTIHOST=1 joins through torchrun's variables (`env://`), gloo
    on the CPU; the collectives of a group of one give back their inputs."""
    from geometry_rl_torch.parallel import DataParallel, is_main_process, maybe_initialize_distributed

    monkeypatch.delenv("GEOMRL_COORDINATOR", raising=False)
    for var, value in (("GEOMRL_MULTIHOST", "1"), ("MASTER_ADDR", "localhost"), ("MASTER_PORT", str(_free_port())),
                       ("RANK", "0"), ("WORLD_SIZE", "1")):
        monkeypatch.setenv(var, value)
    assert maybe_initialize_distributed("cpu")
    try:
        dp = DataParallel()
        assert (dp.rank, dp.world, dp.backend) == (0, 1, "gloo") and is_main_process()
        x = torch.arange(6.0).reshape(3, 2)
        assert torch.equal(dp.all_reduce([x], "max")[0], x) and torch.equal(dp.all_gather(x), x)
        assert torch.equal(dp.broadcast(x), x) and dp.broadcast_object("stamp") == "stamp"
        assert dp.rows(4) == Rows(slice(0, 4), 4)
    finally:
        torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _cli(log_dir, extra_env=None):
    env = {**os.environ, **SUBPROCESS_THREADS, **(extra_env or {})}
    cmd = [sys.executable, "-m", "geometry_rl_torch.train.cli", "--config", "rigid_insertion_multi_hepi_trpl", "--device",
           "cpu", "--override", *TINY_OVERRIDES, f"logger.log_dir={log_dir}"]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=REPO)


def _run_dir(log_dir):
    runs = sorted(glob.glob(os.path.join(log_dir, "*", "metrics.jsonl")))
    assert len(runs) == 1, runs
    return os.path.dirname(runs[0])


def test_two_gloo_processes_match_one_process(tmp_path):
    port = _free_port()
    procs = [_cli(tmp_path / "mh", {"GEOMRL_COORDINATOR": f"localhost:{port}", "GEOMRL_NUM_PROCESSES": "2",
                                    "GEOMRL_PROCESS_ID": str(rank)}) for rank in range(2)]
    procs.append(_cli(tmp_path / "ref"))  # the same config in one process, beside them
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0].decode())
    finally:
        for p in procs:  # never leave a worker blocked in a collective
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    assert "split over 2 processes (gloo), 4 envs each" in outs[0] and "iter" not in outs[1]  # rank 0 prints

    mh, ref = _run_dir(tmp_path / "mh"), _run_dir(tmp_path / "ref")
    rows_mh, rows_ref = ([json.loads(line) for line in open(os.path.join(d, "metrics.jsonl"))] for d in (mh, ref))
    assert len(rows_mh) == len(rows_ref) == 2 and set(rows_mh[0]) == set(rows_ref[0])
    for a, b in zip(rows_ref, rows_mh):
        for k, v in a.items():
            if k not in TIMING:
                assert abs(b[k] - v) <= 1e-4 + 1e-3 * abs(v), (a["step"], k, b[k], v)

    ck_mh, ck_ref = (torch.load(os.path.join(d, "checkpoints", "1", "state.pt"), weights_only=True) for d in (mh, ref))
    for part in ("policy", "critic"):
        for k, v in ck_ref[part].items():
            np.testing.assert_allclose(ck_mh[part][k].numpy(), v.numpy(), atol=5e-5, rtol=1e-4, err_msg=f"{part}.{k}")
    def flat(tree):
        return [x for t in tree for x in flat(t)] if isinstance(tree, list) else [tree]

    env_mh, env_ref = flat(ck_mh["state"]["env_state"]), flat(ck_ref["state"]["env_state"])
    assert len(env_mh) == len(env_ref)
    for a, b in zip(env_mh, env_ref):  # the whole env state, gathered from both ranks
        if torch.is_tensor(b) and b.is_floating_point():
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)
        elif torch.is_tensor(b):
            assert torch.equal(a, b)

    # the 2-rank checkpoint restores and evaluates in one process
    from geometry_rl_torch.config import load_config, trainer_from_config
    from geometry_rl_torch.train import play
    from geometry_rl_torch.train.checkpoint import restore_checkpoint

    cfg = load_config(None, json.load(open(os.path.join(mh, "hparams.json"))))
    trainer = trainer_from_config(cfg, device="cpu")
    state = restore_checkpoint(os.path.join(mh, "checkpoints"), trainer, trainer.init(torch.Generator().manual_seed(0)), 1)
    assert torch.equal(state.env_state.scene.bodies.pos, ck_mh["state"]["env_state"][0][0][0])
    results = play.main(["--run-dir", mh, "--checkpoint", "checkpoints", "--episodes-steps", "8", "--device", "cpu"])
    assert all(np.isfinite(e["reward"]) for e in results.values())
