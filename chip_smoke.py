#!/usr/bin/env python3
"""Build the port's CUDA kernels and drive its cloth_hanging, rigid_insertion, rope_closing and two-gripper HEPi paths, its EMPN and Transformer paths, clipped PPO, KL-penalty PPO and PAPI, behaviour cloning, the runner, rollout rendering, data parallelism and the evaluation tools on one GPU, and show that two runs from one seed give the same bits.

    python3 chip_smoke.py
    python3 chip_smoke.py --new-phases [31 | 28,30]   # phases 1, 2 and 28-35 (or those listed) only, no result lines
    python3 chip_smoke.py --new-phases 15             # phase 15b alone, on the updates of short runs
    python3 chip_smoke.py --keep-going   # report every failed gate, then exit non-zero

Phases, each printing a line; any failure raises and exits non-zero:
  1. device: card name and power limit (nvidia-smi), torch / CUDA versions;
     TF32 off for matmuls and convolutions.
  2. build: compile (or reuse) csrc/cloth_solve.cu and csrc/cloth_solve_env.cu
     (both instantiate csrc/cloth_solve_common.cuh) and csrc/segment_sum.cu
     (the graph models' fixed-order message sums) into
     geometry_rl_torch/_build/, the three nvcc runs at once; per kernel, the
     registers, shared memory and spill bytes ptxas reported. The main paths'
     instantiations must not spill.
  3. kernels vs plain version on the card, on the real ClothEnv topology:
     each kernel at B = 100 and B = 1000 with self-collision off (the main
     paths' shapes) and B = 4 with it on, max |diff| <= 2e-4; K1's port
     against K2's on the same operands. Per kernel and shape: device ms per
     launch (a CUDA graph of 50 launches replayed 10 times, CUDA events),
     eager ms per call of the wrapper (200 calls) and the host's share of it,
     the plain version's ms, and the roofline bound from `solve_cost` (bytes
     over 3.35 TB/s, f32 operations over 67 TFLOP/s: the H100 SXM's published
     peaks), counting the hook contacts and self-collision hits the plain
     version made on these inputs.
  4. the rollout at full width (cloth_hanging_multi_hepi_trpl: 100 envs,
     latent 64, 16 orientations, the config's dtype): init(seed 0), one
     10,000-frame _collect, one 100-step eval_success. Outputs finite and on
     the card; K2's port ran exactly 2 x (10 + 100 + 10 + 100) = 440 times;
     HEPi's message sums launched the segment-sum kernel, and no CSR was made
     on the spot.
  5. the rollout on a small input (4 envs, f32): 3 deterministic steps on the
     card, each also taken by the CPU (where the solve is the plain version)
     from a copy of the card's state: actions, rewards and particle positions
     within SLICE_TOL of their scale. The CPU's free run of the same 3 steps
     is printed beside, not gated.
  6. training at full width through the CLI (`train.cli.main`, --device cuda,
     env.kwargs.use_pallas_solver=true, one iteration of 100 envs x 100 steps,
     5 epochs x 50 minibatches of 200): metrics.jsonl has a finite row with
     the reference's keys, the params moved, K1's port ran exactly
     2 x (10 + 100) = 220 times and K2's never, and the last checkpoint
     restores bit-exactly into a fresh trainer. Seconds per iteration, collect
     and update apart. Every training phase (6, 10, 15, 18-20, 23-25) also
     counts the segment-sum kernel's launches: more than 0 for a graph model
     (HEPi, EMPN), 0 for the Transformer, and no CSR made on the spot.
  7. `train.play` on that run: 100 steps, success threshold 0.1, eval.json.
  8. one `_update` (1 epoch, 2 minibatches) on the card against the CPU, 4
     envs, f32, the same batch, params and permutation: first-minibatch
     gradients within 1e-4 of their global norm, params within 1e-5.
  9. the rigid_insertion rollout on a small input (4 envs, f32), as phase 5:
     actions, rewards and body positions within SLICE_TOL of their scale.
 10. rigid_insertion training at full width through the CLI
     (rigid_insertion_multi_hepi_trpl: 1000 envs x 100 steps, latent 64, 16
     orientations, bf16 activations, 5 epochs x 100 minibatches of 1000; one
     iteration): the checks of phase 6, and neither cloth kernel launches.
     Seconds per iteration, collect and update apart, and collect env-steps/s.
 11. `train.play` on that run, as phase 7.
 12. `torch.profiler` over 2 control steps of the rigid_insertion collect at
     1000 envs (`train/profile.py`'s `collect_window`): device kernels per
     control step, device busy ms and idle share, the device time under the
     env step, the policy and the critic, the 5 ops and 5 kernels with the
     most device time, and the port's kernels per control step.
 13. the cloth env in solver mode `use_pallas_solver=False` (the XPBD
     `step_physics` solver in plain PyTorch, grippers as real bodies) at full
     width (100 envs): 3 control steps from the same state and actions as a
     "tiled" env, both advancing the same state each step; particle and
     gripper positions within 2e-4, and the `False` env launches neither
     kernel. A second, independent plain path that holds K2's port.
 14. rope_closing and rope_shaping on a small input (4 envs, f32), as phase
     5: actions, rewards, link and gripper positions within SLICE_TOL of
     their scale.
 15. rope_closing training at full width through the CLI
     (rope_closing_hepi_trpl: 200 envs x 200 steps, 40 links, latent 64, 16
     orientations, the config's dtype, 5 epochs x 200 minibatches of 200; one
     iteration): the checks of phase 10, and neither cloth kernel launches.
 15b. the segment-sum kernel on the largest call of the updates of phases 6
     (cloth), 10 (rigid: the kNN CSR of each env) and 15 (rope), recorded
     as they ran: bit-equal to its plain version (SEGMENT_TOL = 0: the same
     order of f32 adds); device ms per launch (a CUDA graph of 50), the plain
     version's ms, `index_add_` into f32 on the same rows and destinations
     and the same under PyTorch's deterministic algorithms, and the bound
     (values, perm and offsets read once, the output written once).
 16. `train.play` on that run (200 steps, threshold 0.1), as phase 11.
 17. `torch.profiler` over 2 control steps of the rope_closing collect at 200
     envs, as phase 12.
 18. EMPN training at full width through the CLI
     (cloth_hanging_multi_empn_trpl: 100 envs x 100 steps, latent 64, 16
     orientations, bf16, 5 epochs x 50 minibatches of 200; one iteration):
     the checks of phase 10, K2's port ran exactly 2 x (10 + 100) = 220 times
     (solver mode "auto") and K1's never. Peak device memory of the iteration.
 19. Transformer training at full width through the CLI
     (rigid_insertion_multi_transformer_trpl: 1000 envs x 100 steps; one
     iteration, its update cut in depth to 1 epoch of 100 minibatches of 1000,
     from the YAML's 5, for the script's time): the checks of phase 10.
 20. two-gripper HEPi training at full width through the CLI
     (rigid_insertion_two_agents_multi_hepi_trpl: 1000 envs x 100 steps, the
     std floor and cap and the gradient clip of its YAML; one iteration, 1
     epoch as phase 19): the checks of phase 10; then `train.play` on that
     run.
 21. every other model on a small input (4 envs, f32), as phase 5: empn,
     transformer, gcn, meshgraphnet and mlp on rigid_insertion and empn and
     transformer on cloth_hanging.
 22. `train/profile.py`'s update window (10 minibatch steps) on the EMPN
     cloth config, the Transformer rigid config and the two-gripper HEPi
     config: ms and device kernels per minibatch step, by part of the step,
     the device's idle share and the window's peak device memory.
 23. KL-penalty PPO at full width through the CLI (RIGID_CONFIG with
     algo=kl_ppo, kl_beta_interval=iteration; one iteration): finite rows with
     the JAX package's kl_ppo keys, the checkpoint (kl_beta with it) restores
     bit-exactly, beta moved by at most a factor of 2, neither cloth kernel
     launches.
 24. clipped PPO at full width through the CLI (cloth_hanging_multi_hepi_trpl
     with algo=ppo; one iteration, solver mode "auto"): `clip_fraction` in
     the rows, K2's port exactly 220 launches and K1's none, bit-exact restore.
 25. PAPI at full width through the CLI (cloth_hanging_multi_transformer_trpl
     with proj_type=papi, a non-contextual std and papi_steps; one
     iteration): finite `papi/n_backtracks`, 0 < `papi/lr_scale` <= 1, K2's
     port 220 launches, the checkpoint and `<checkpoints>_papi` restore
     bit-exactly; then ms, kernels and peak device memory of the PAPI steps.
 26. one `_update` card vs CPU (4 envs, f32, phase 8's method) for ppo,
     kl_ppo with both beta intervals, and TRPL with the frob, w2 and papi
     projections; the PAPI steps after an update on the cloth Transformer;
     the full-covariance projections and their gradients at k = 6, 12.
 27. `train/profile.py`'s update window (10 minibatch steps) for kl_ppo and
     ppo on RIGID_CONFIG: ms and device kernels per minibatch step, by part.
 28. behaviour cloning at full width through `train.bc_cli`
     (cloth_hanging_multi_hepi_trpl: 100 envs x 100 recorded steps from a
     fresh init, 5 epochs of 39 minibatches of 256, an eval of 100 steps at
     epoch 0 and the final success eval), then `train.play` on `cloned/`: K2's
     port launches exactly 2 x (10 + 100) times in the recording and in each
     eval; the dataset's keys and shapes; finite `bc_loss`, lower in the fifth
     epoch than in the first; one BC epoch card vs CPU (4 envs, f32, the same
     data and permutation): first gradients within GRAD_TOL of their norm,
     each minibatch's loss and the policy's mean after it within BC_TOL.
 29. `train.runner.OnPolicyRunner` with its defaults (rigid_pushing, HEPi,
     ppo, 256 envs x 24 steps): `learn(1)`, `save` / `load` bit-exact, the
     inference policy card vs CPU within SLICE_TOL.
 30. `train.render.collect_frames` of cloth env 0 for 100 deterministic steps
     at full width: K2's port exactly 2 x (10 + 100) launches; each frame
     within SLICE_TOL of the CPU's step from the card's state; a GIF where
     matplotlib is installed (else its ImportError is printed).
 31. data parallelism on one card: rank 1's env against rows 50..100 of the
     one-process env; 2 gloo processes x 50 envs on cuda:0 beside two
     one-process runs x 100 of cloth_hanging_multi_hepi_trpl (f32, one
     iteration, 1 update epoch, without PyTorch's deterministic algorithms):
     the collect's metrics and env state within tests/test_parallel.py's
     tolerances, the first minibatch step within DP_FIRST_GRAD_TOL /
     DP_FIRST_METRIC_SCALE, the two one-process runs equal at the first
     minibatch step and after the whole update; 2 ranks after the whole
     update printed; K2's port 2 x (10 + 100) launches in every process, the
     2-rank checkpoint restored in one process; then a one-rank NCCL launch
     through the CLI.
 32. `tools.smoke_env` on all 7 tasks (4 envs, 3 random steps): the last
     observations finite and on the card; K2's port exactly 2 x (10 + 3)
     launches on cloth_hanging, neither kernel on the other tasks.
 33. `tools.eval_breakdown --episodes 1` on phase 10's run (1000 envs, 8 peg
     shapes): every shape reported, the per-shape episodes sum to the
     overall count, every value finite, no cloth kernel launched.
 34. `tools.learn_check` on cloth_hanging at the config's width (100 envs,
     minibatches of 200, 2 iterations): two finite rows with the JAX
     script's keys and a SUMMARY line; K2's port exactly 2 x 2 x 100
     launches (the tool's env has no warm-up steps), K1's none.
 35. reproducibility, without PyTorch's deterministic algorithms: each of
     cloth_hanging HEPi in solver mode "auto" (K2's port) and with
     use_pallas_solver=true (K1's), rigid_insertion HEPi, rope_closing HEPi,
     cloth EMPN, the rigid Transformer, the two-gripper HEPi and
     rigid_pushing HEPi with dynamic_friction_scale=1.0 (the XPBD velocity
     pass), at its full width and in its dtype, cut to 10 control steps and
     one update epoch, twice from one seed: every metric, param, Adam state,
     normaliser and env state tensor equal (NaN equal to NaN);
     `tools.eval_breakdown` again on phase 10's run: phase 33's report; in
     one child process, cloth and rigid HEPi without and with
     `torch.use_deterministic_algorithms(True)`: the same bits, no warning.
Then one JSON line with the kernels, and the last line
{"ok": true, "device": {...}}.

It needs a CUDA card and the repository beside it; without either it exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SOLVE_TOL = 2e-4  # the JAX package's own Pallas-vs-XLA gate
# the H100 SXM's published peaks (HBM bytes/s, f32 outside the tensor cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# card vs CPU for one step from the same state, relative to each quantity's
# scale: f32 sums in another order are ~1e-7 apart (relative), the kernel is
# a few 1e-6 from the plain solve; the untrained policy's mean actions reach
# ~1e2, and the action-rate reward term squares them
SLICE_TOL = 1e-4
# card vs CPU over one update phase: the card's matrix products and reductions
# sum in another order than the CPU's, so gradients agree to rounding
# relative to their global norm; Adam moves each param by at most
# ~lr = 3e-4 per step, normalised by the gradient's scale
GRAD_TOL = 1e-4
PARAM_TOL = 1e-5
# the full-covariance projections in f32 on the card and on the CPU, each
# against the same functions in f64 on the CPU: an f32 program's own error
# through a 60-round bisection and its implicit gradient reaches 7.4e-5 of
# scale at k = 12 on the CPU (the covariance-only projection's gradient), so
# two f32 programs cannot be held to each other much closer than that
FULLCOV_TOL = 2e-4
LIBRARIES = ("cloth_solve", "cloth_solve_env", "segment_sum")
# the paper's headline configuration: 1000 envs x 100 steps per iteration
RIGID_CONFIG = "rigid_insertion_multi_hepi_trpl"
# the deformable-chain family: 200 envs x 200 steps per iteration, 40 links
ROPE_CONFIG = "rope_closing_hepi_trpl"
# the kernel each library launches on the main paths (the cloth solves with
# self-collision off; both type instantiations of the segment sum)
MAIN_PATH_KERNELS = {"cloth_solve": "cloth_solve_kernel", "cloth_solve_env": "cloth_solve_env_kernel",
                     "segment_sum": "segment_sum_kernel"}
# the segment-sum kernel adds in the plain version's order: bit-equal
SEGMENT_TOL = 0.0
# the graph models, whose every forward sums messages with the segment-sum kernel
GRAPH_MODELS = ("hepi", "empn", "gcn", "meshgraphnet")
# the reference's per-iteration metric keys: the loss's own keys by algorithm
# (TRPL with its constraint metrics, clipped PPO, KL-penalty PPO), then the
# update's, the collect's and the CLI's
COMMON_KEYS = (
    "loss_objective", "loss_entropy", "loss_critic", "entropy", "ESS", "value_clip_fraction", "policy_std",
    "policy_std_min", "grad_norm_actor", "grad_norm_actor_max", "train/explained_variance", "train/reward",
    "train/episodes", "train/iteration_time", "train/frames",
)
ALGO_KEYS = {
    "trpl": ("loss_trust_region", "kl", "constraint", "mean_constraint", "cov_constraint", "entropy_diff", "kl_max",
             "constraint_max", "mean_constraint_max", "cov_constraint_max", "entropy_max", "entropy_diff_max"),
    "ppo": ("clip_fraction",),
    "kl_ppo": ("kl", "kl_mean_part", "kl_cov_part", "kl_penalty_beta", "kl_penalty_beta_max"),
}
PAPI_KEYS = ("papi/n_backtracks", "papi/lr_scale", "train/papi_time")


FAILURES = []  # with --keep-going, the failed gates, reported at the end


def fail(msg: str) -> None:
    if "--keep-going" in sys.argv:
        print(f"[FAILED] {msg}", flush=True)
        FAILURES.append(msg)
        return
    raise RuntimeError(f"chip_smoke: {msg}")


def timed_ms(fn, n: int):
    """(ms per call of `fn` launched eagerly, between two CUDA events; host
    ms per call, the host clock over the same loop with no synchronisation
    inside it: what the caller spends issuing a call)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / n
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n, host


def graph_ms(fn, launches: int = 50, replays: int = 10) -> float:
    """Device ms per call of `fn`: `launches` calls captured in a CUDA graph,
    replayed `replays` times between two CUDA events, so the caller's host
    time is not counted."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (launches * replays)


def bound_ms(nbytes: int, flops: int):
    """The least time the card could take for the work: (ms, "bytes" or
    "operations", whichever bounds it)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main_path_kernels(lib: str, info: dict) -> list:
    """The names ptxas reported for `lib`'s main-path kernel: the name itself,
    or the C++ names of its template instantiations."""
    want = MAIN_PATH_KERNELS[lib]
    return [k for k in info if k == want] or [k for k in info if k.startswith("_Z") and want in k]


def segment_counts():
    """(the segment-sum kernel's launches, the CSRs made on the spot) since the last reset."""
    from geometry_rl_torch.models.segment import LAUNCHES as SEG, ON_THE_SPOT

    return SEG["segment_sum"], ON_THE_SPOT["csr"]


def reset_segment_counts() -> None:
    from geometry_rl_torch.models.segment import LAUNCHES as SEG, ON_THE_SPOT

    SEG["segment_sum"] = ON_THE_SPOT["csr"] = 0


class LargestSegmentCall:
    """While open, keeps a copy of the largest (by values) call of the
    segment-sum kernel made inside `Trainer._update`: the update's forwards
    and their backward. `into[key]` = (values, csr)."""

    def __init__(self, into: dict, key: str):
        self.into, self.key, self.updating = into, key, False

    def __enter__(self):
        from geometry_rl_torch.graphs.types import CSR
        from geometry_rl_torch.models import segment
        from geometry_rl_torch.train import ppo

        self.launch, self.update = segment.segment_sum_cuda, ppo.Trainer._update

        def recording(values, csr):
            best = self.into.get(self.key)
            if self.updating and (best is None or values.numel() > best[0].numel()):
                self.into[self.key] = (values.clone(), CSR(csr.perm.clone(), csr.offsets.clone()))
            return self.launch(values, csr)

        def updating(trainer, *args, **kwargs):
            self.updating = True
            try:
                return self.update(trainer, *args, **kwargs)
            finally:
                self.updating = False

        segment.segment_sum_cuda, ppo.Trainer._update = recording, updating
        return self

    def __exit__(self, *exc):
        from geometry_rl_torch.models import segment
        from geometry_rl_torch.train import ppo

        segment.segment_sum_cuda, ppo.Trainer._update = self.launch, self.update
        return False


def segment_kernel_phase(card: str, calls: dict) -> dict:
    """The segment-sum kernel on the largest call of each training phase's
    update (recorded by `LargestSegmentCall`): bit-equal to its plain version
    (SEGMENT_TOL), device ms per launch (a CUDA graph of 50 launches), the
    plain version's ms, the bound (values, perm and offsets read once, the
    output written once, over 3.35 TB/s; one f32 add per value over 67
    TFLOP/s), and the library's: one `index_add_` into f32 on the same rows
    and destinations (the sum in an order that changes from run to run; it
    reads the rows in f32, twice the bytes of bf16 values), the same call under
    PyTorch's deterministic algorithms (an accumulating `index_put_` that sorts
    the indices on every call), and what the parent's `scatter_sum` ran for
    the same sum from the values' own dtype (zeros, a cast to f32,
    `index_add_`, a cast back). Returns per family (max_abs_err, ms, plain_ms,
    bound_ms, bound_by, library_ms, library_det_ms, shape, index_add_sequence_ms)."""
    import torch

    from geometry_rl_torch.models.segment import segment_sum_cuda, segment_sum_ref

    t_phase = time.perf_counter()
    stats = {}
    for family, (values, csr) in calls.items():
        B, E, F = values.shape
        n, Bp = csr.num_segments, csr.perm.shape[0]
        got, want = segment_sum_cuda(values, csr), segment_sum_ref(values, csr)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ms = graph_ms(lambda: segment_sum_cuda(values, csr))
        plain_ms = timed_ms(lambda: segment_sum_ref(values, csr), 3)[0]
        # each row's destination, back from the CSR, on the flattened (env, node) axis
        pos = torch.arange(E, device=values.device).expand(Bp, E).contiguous()
        seg = torch.searchsorted(csr.offsets[:, 1:].contiguous().long(), pos, right=True)
        dst = torch.empty_like(seg).scatter_(1, csr.perm.long(), seg).expand(B, E)
        flat = (dst + n * torch.arange(B, device=values.device)[:, None]).reshape(-1)
        rows = values.float().reshape(B * E, F)
        acc = torch.zeros((B * n, F), device=values.device)
        library_ms = timed_ms(lambda: acc.index_add_(0, flat, rows), 10)[0]
        torch.use_deterministic_algorithms(True)
        try:
            library_det_ms = timed_ms(lambda: acc.index_add_(0, flat, rows), 10)[0]
        finally:
            torch.use_deterministic_algorithms(False)
        own = values.reshape(B * E, F)
        sequence_ms = timed_ms(lambda: torch.zeros((B * n, F), device=values.device).index_add_(
            0, flat, own.float()).to(values.dtype), 10)[0]
        elt = values.element_size()
        nbytes = values.numel() * elt + 4 * csr.perm.numel() + 4 * csr.offsets.numel() + B * n * F * elt
        bound, bound_by = bound_ms(nbytes, values.numel())
        depth = (csr.offsets[:, 1:] - csr.offsets[:, :-1]).max().item()
        print(f"[kernel] segment_sum, {family}'s largest update call: values [{B}, {E}, {F}] {values.dtype}, "
              f"{n} segments, CSR of {'each env' if Bp > 1 else 'all envs'}, longest segment {depth}: max|kernel - "
              f"plain| = {err:.3e} (tol {SEGMENT_TOL}); kernel {ms:.5f} ms on the device, plain {plain_ms:.4f} ms, "
              f"index_add_ (f32 rows) {library_ms:.5f} ms, index_add_ under deterministic algorithms "
              f"{library_det_ms:.5f} ms, zeros + cast + index_add_ + cast from {values.dtype} {sequence_ms:.5f} ms; "
              f"bound {bound:.5f} ms by {bound_by} ({nbytes} bytes), {100 * bound / ms:.2f}% of it; on {card}")
        if not err <= SEGMENT_TOL:
            fail(f"segment_sum disagrees with its plain version on {family}'s call: {err}")
        stats[family] = (err, ms, plain_ms, bound, bound_by, library_ms, library_det_ms, [B, E, F], sequence_ms)
    print(f"[kernel] segment_sum phase took {time.perf_counter() - t_phase:.2f} s")
    if sorted(stats) != sorted(calls) or not stats:
        fail(f"segment_sum was checked on {sorted(stats)}: no update call was recorded")
    return stats


def moved(obj, device):
    """Tensors of a NamedTuple / dict tree moved to `device`."""
    import torch

    if torch.is_tensor(obj):
        return obj.to(device)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(moved(o, device) for o in obj))
    if isinstance(obj, dict):
        return {k: moved(v, device) for k, v in obj.items()}
    return obj


def solve_inputs(env, generator):
    """Operands of one substep's solve from a reset layout: the cloth folded
    over itself along its middle row (rows 8..14 laid 4 cm above rows 6..0,
    closer than the self-collision distance; the grippers follow their
    corners), jittered by 5 mm, with the hook
    through the cloth's centre so contact is exercised."""
    import torch

    state = env.reset(generator)
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
    x = (x + 0.005 * torch.randn(x.shape, generator=generator, device=env.device)).contiguous()
    hanger = (x[:, 112] + torch.tensor([0.03, -0.3, 0.0], device=env.device)).contiguous()
    return (env.solve_spec, x, prev, env.inv_all, hanger, env.att_body_w, env.corner_indices,
            env.groups, env.self_pair_mask_full, env.self_active_full)


def train_phase(card: str, config: str, overrides, expected: dict, record=None):
    """Full-width training through the CLI (`config` with `overrides`, on the
    card): the cloth kernels must launch exactly `expected` times, a graph
    model's message sums launch the segment-sum kernel and never make a CSR
    on the spot, and `record` (a `LargestSegmentCall`) keeps the update's
    largest call of that kernel; every
    metrics row is finite with the reference's keys for its algorithm, the
    params move, and the last checkpoint restores bit-exactly into a fresh
    trainer; with PAPI steps so does PAPI's carry (`<checkpoints>_papi`), and
    0 < lr_scale <= 1. With kl_beta_interval "iteration", beta moves by at
    most one factor of 2 per iteration. Returns the run dir and the launch
    counts."""
    import torch

    from geometry_rl_torch.config import load_config, trainer_from_config
    from geometry_rl_torch.sim.cloth_solve import LAUNCHES
    from geometry_rl_torch.train import cli
    from geometry_rl_torch.train.checkpoint import STATE_FILE, latest_step, restore_checkpoint, restore_tree

    t_phase = time.perf_counter()
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    overrides = [*overrides, "logger.checkpoint.save_interval=1", f"logger.log_dir={log_dir}"]
    cfg = load_config(config, cli.parse_overrides(overrides))
    B, T = cfg["env"]["num_envs"], cfg["collector"]["frames_per_batch"] // cfg["env"]["num_envs"]
    iterations = cfg["collector"]["total_frames"] // cfg["collector"]["frames_per_batch"]
    LAUNCHES.update(cloth_solve=0, cloth_solve_env=0)
    reset_segment_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with record or contextlib.nullcontext():
        run_dir = cli.main(["--config", config, "--device", "cuda", "--override", *overrides])
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    segment, on_the_spot = segment_counts()
    print(f"[train] {config}: {iterations} iterations of {B} envs x {T} steps; cloth kernel launches {launches} "
          f"(expected {expected}); segment_sum launches {segment}, CSRs made on the spot {on_the_spot}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if launches != expected:
        fail(f"the training path of {config} launched {launches}, expected {expected}")
    if (cfg["model"] in GRAPH_MODELS) != (segment > 0) or on_the_spot:
        fail(f"the training path of {config} ({cfg['model']}) launched segment_sum {segment} times and made "
             f"{on_the_spot} CSRs on the spot")
    launches["segment_sum"] = segment

    rows = [json.loads(line) for line in open(os.path.join(run_dir, "metrics.jsonl"))]
    if len(rows) != iterations:
        fail(f"metrics.jsonl has {len(rows)} rows, expected {iterations}")
    obj = cfg["algorithm"]["objective"]
    keys = set(COMMON_KEYS) | set(ALGO_KEYS[cfg["algo"]]) | (set(PAPI_KEYS) if obj["papi_steps"] else set())
    for row in rows:
        missing = keys - set(row)
        if missing:
            fail(f"metrics.jsonl row {row['step']} lacks {sorted(missing)}")
        bad = [k for k, v in row.items() if not (isinstance(v, (int, float)) and abs(v) < float("inf"))]
        if bad:
            fail(f"metrics.jsonl row {row['step']} has non-finite {bad}")
        print(f"[train] {config} iteration {row['step']}: {row['train/iteration_time']:.3f} s = collect "
              f"{row['train/collect_time']:.3f} s ({B * T / row['train/collect_time']:.1f} env-steps/s) + update "
              f"{row['train/update_time']:.3f} s on {card}; reward {row['train/reward']:.3f}, kl "
              f"{row.get('kl', float('nan')):.5f}, ESS {row['ESS']:.4f}, explained variance "
              f"{row['train/explained_variance']:.4f}; algo {cfg['algo']}"
              + "".join(f", {k} {row[k]:.5g}" for k in ("clip_fraction", "kl_penalty_beta", "train/papi_time",
                                                        "papi/n_backtracks", "papi/lr_scale") if k in row))
        if obj["papi_steps"] and not 0.0 < row["papi/lr_scale"] <= 1.0:
            fail(f"papi/lr_scale {row['papi/lr_scale']} is outside (0, 1]")

    # a fresh trainer: its own init params, then the last checkpoint bit-exactly
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    step = latest_step(ckpt_dir)
    fresh = trainer_from_config(cfg, device="cuda")
    template = fresh.init(torch.Generator(device="cuda").manual_seed(cfg["seed"]))
    init_params = {k: v.clone() for k, v in fresh.policy.state_dict().items()}
    state = restore_checkpoint(ckpt_dir, fresh, template, step)
    saved = torch.load(os.path.join(ckpt_dir, str(step), STATE_FILE), map_location="cpu", weights_only=True)
    moved = max((saved["policy"][k] - v.cpu()).abs().max().item() for k, v in init_params.items())
    if not moved > 1e-4:
        fail(f"the policy params did not move in training (max change {moved})")
    for part, module in (("policy", fresh.policy), ("critic", fresh.critic)):
        for k, v in module.state_dict().items():
            if not torch.equal(v.cpu(), saved[part][k]):
                fail(f"restored {part}.{k} differs from the checkpoint")
    for field in ("actor_opt", "critic_opt"):
        got, want = getattr(state, field).state_dict(), saved[field]
        for i, entry in want["state"].items():
            if not all(torch.equal(got["state"][i][k].cpu(), v) for k, v in entry.items()):
                fail(f"restored {field} state {i} differs from the checkpoint")
    from geometry_rl_torch.train.checkpoint import _plain

    def same(a, b):
        if torch.is_tensor(b):
            return torch.equal(a.cpu(), b)
        if isinstance(b, (list, tuple)):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        if isinstance(b, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in b)
        return a == b

    for field, value in saved["state"].items():
        if not same(_plain(getattr(state, field)), value):
            fail(f"restored TrainState.{field} differs from the checkpoint")
    extra = ""
    if cfg["algo"] == "kl_ppo":
        beta0, beta = obj["kl_beta"], state.kl_beta.item()
        extra += f"; kl_beta {beta0} -> {beta}"
        if obj["kl_beta_interval"] == "iteration" and not beta0 / 2 ** iterations <= beta <= beta0 * 2 ** iterations:
            fail(f"kl_beta moved from {beta0} to {beta} in {iterations} iteration(s)")
    if obj["papi_steps"]:
        papi_dir = ckpt_dir + "_papi"
        papi_state = restore_tree(papi_dir, fresh.papi_init(state), step)
        saved_papi = torch.load(os.path.join(papi_dir, str(step), STATE_FILE), map_location="cpu", weights_only=True)
        if not same(_plain(papi_state), saved_papi["tree"]):
            fail("the restored PAPI state differs from its checkpoint")
        extra += (f"; PAPI state {step} restored bit-exactly (history of {papi_state.history['mean.weight'].shape[0]}, "
                  f"hist_len {int(papi_state.hist_len)}, lr_scale {float(papi_state.lr_scale)})")
    print(f"[train] checkpoint {step} restored bit-exactly into a fresh trainer (params, Adam states, normaliser, "
          f"env state, generators, num_updates {state.num_updates}){extra}; policy params moved up to {moved:.3e} "
          f"from init; phase took {time.perf_counter() - t_phase:.2f} s")
    return run_dir, launches


def update_parity_phase(config: str = "cloth_hanging_multi_hepi_trpl", overrides: tuple = (), papi: bool = False) -> None:
    """Phases 8 and 26: the same batch, params and permutation through one
    `_update` (1 epoch x 2 minibatches of 20) on the card and on the CPU (4
    envs, f32, full-width model), for `config` with `overrides`: first-
    minibatch gradients within GRAD_TOL of their global norm, params within
    PARAM_TOL, the KL-penalty beta equal. With `papi`, PAPI's steps then run
    on both from the same batch: params within PARAM_TOL, the same
    backtracks."""
    import torch

    from geometry_rl_torch.config import _merge, load_config, trainer_from_config
    from geometry_rl_torch.train.cli import parse_overrides

    t_phase = time.perf_counter()
    small = load_config(config, overrides=_merge({
        "env": {"num_envs": 4, "kwargs": {"warmup_steps": 2}}, "collector": {"frames_per_batch": 40},
        "algorithm": {"dtype": "float32", "objective": {"ppo_epochs": 1, "mini_batch_size": 20}},
    }, parse_overrides(overrides)))
    gpu, cpu = trainer_from_config(small, device="cuda"), trainer_from_config(small, device="cpu")
    g_state = gpu.init(torch.Generator(device="cuda").manual_seed(0))
    g_state, batch, _ = gpu._collect(g_state)
    c_state = cpu.init(torch.Generator().manual_seed(0))
    cpu.policy.load_state_dict(gpu.policy.state_dict())
    cpu.critic.load_state_dict(gpu.critic.state_dict())
    c_state = c_state._replace(norm=moved(g_state.norm, "cpu"), obs=moved(g_state.obs, "cpu"),
                               initial_entropy=g_state.initial_entropy.cpu())
    c_batch = moved(batch, "cpu")
    n = batch.action.shape[0] * batch.action.shape[1]
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(0))[:40].reshape(2, 20)
    first_grads = {}
    for name, tr in (("cuda", gpu), ("cpu", cpu)):
        tr._permutation = lambda generator, n, dev=tr.device: perm.to(dev)
        step = tr._minibatch_step

        def recording(state, mb, num_updates, *args, tr=tr, step=step, name=name):
            out = step(state, mb, num_updates, *args)
            if name not in first_grads:
                first_grads[name] = torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad).reshape(-1).cpu()
                                               for m in (tr.policy, tr.critic) for p in m.parameters()])
            return out

        tr._minibatch_step = recording
    if gpu.num_minibatches != 2 or gpu.mini_batch_size != 20:
        fail(f"the update phase has {gpu.num_minibatches} minibatches of {gpu.mini_batch_size}, expected 2 of 20")
    g_state, g_metrics = gpu._update(g_state, batch)
    c_state, c_metrics = cpu._update(c_state, c_batch)
    torch.cuda.synchronize()

    def param_err():
        return max((v.cpu() - getattr(cpu, part).state_dict()[k]).abs().max().item()
                   for part in ("policy", "critic") for k, v in getattr(gpu, part).state_dict().items())

    g, c = first_grads["cuda"], first_grads["cpu"]
    grad_err = (g - c).abs().max().item() / c.norm().item()
    update_err = param_err()
    what = f"{config}" + (f" with {' '.join(overrides)}" if overrides else "")
    beta = "" if g_state.kl_beta is None else f"; kl_beta {g_state.kl_beta.item()} vs {c_state.kl_beta.item()}"
    print(f"[update] {what}: one update phase (1 epoch x 2 minibatches of 20, 4 envs, f32), card vs CPU: first-"
          f"minibatch gradients max |diff| / global norm = {grad_err:.3e} (tol {GRAD_TOL}), params after max |diff| = "
          f"{update_err:.3e} (tol {PARAM_TOL}); loss_critic {g_metrics['loss_critic'].item():.5f} vs "
          f"{c_metrics['loss_critic'].item():.5f}{beta}")
    if not grad_err <= GRAD_TOL:
        fail(f"the card's gradients disagree with the CPU's: {grad_err}")
    if not update_err <= PARAM_TOL:
        fail(f"the card's params after the update disagree with the CPU's: {update_err}")
    if g_state.kl_beta is not None and g_state.kl_beta.item() != c_state.kl_beta.item():
        fail(f"the card's kl_beta {g_state.kl_beta.item()} differs from the CPU's {c_state.kl_beta.item()}")
    if papi:
        g_papi, g_m = gpu._papi_steps(g_state, batch, gpu.papi_init(g_state))
        c_papi, c_m = cpu._papi_steps(c_state, c_batch, cpu.papi_init(c_state))
        torch.cuda.synchronize()
        papi_err = param_err()
        print(f"[update] {what}: PAPI steps on the same batch, card vs CPU: params max |diff| = {papi_err:.3e} "
              f"(tol {PARAM_TOL}); backtracks {g_m['papi/n_backtracks'].item():.0f} vs {c_m['papi/n_backtracks'].item():.0f}")
        if not papi_err <= PARAM_TOL or g_m["papi/n_backtracks"].item() != c_m["papi/n_backtracks"].item():
            fail(f"the card's PAPI steps disagree with the CPU's: {papi_err}, {g_m} vs {c_m}")
    print(f"[update] phase took {time.perf_counter() - t_phase:.2f} s")


def fullcov_parity_phase(card: str, batch: int = 256) -> None:
    """Phase 26's second half: the full-covariance projections on seeded SPD
    batches at the tasks' action widths (k = 6, 12), in f32 on the card and
    on the CPU: outputs and the gradients of a seeded linear function of them,
    each within FULLCOV_TOL of max(1, scale) of the CPU's f64 result; the card
    against the CPU in f32 is printed beside it."""
    import numpy as np
    import torch

    from geometry_rl_torch.rl.projections import fullcov

    t_phase = time.perf_counter()
    worst, worst_pair = 0.0, 0.0
    for k in (6, 12):
        rng = np.random.default_rng(k)

        def spd(scale, shift):
            a = rng.normal(size=(batch, k, k)) * scale
            return a @ a.transpose(0, 2, 1) / k + shift * np.eye(k)

        old_cov = spd(1.0, 0.5)
        cov = old_cov + spd(0.3, 0.05)
        old_mean = rng.normal(size=(batch, k))
        mean = old_mean + 0.3 * rng.normal(size=(batch, k))
        sqrt, old_sqrt = spd(0.5, 0.5), spd(0.5, 0.5)  # symmetric positive definite roots
        cases = {
            "kl_full_cov_projection": (lambda c, o: fullcov.kl_full_cov_projection(c, o, 0.02), (cov, old_cov), (0,)),
            "kl_full_joint_projection": (lambda m, c, om, oc: fullcov.kl_full_joint_projection(m, c, om, oc, 0.1),
                                         (mean, cov, old_mean, old_cov), (0, 1)),
            "w2_non_commutative_projection": (lambda m, s, om, os: fullcov.w2_non_commutative_projection(m, s, om, os, 0.2),
                                              (mean, sqrt, old_mean, old_sqrt), (0, 1)),
            "w2_non_commutative_parts(scale_prec)": (
                lambda m, s, om, os: fullcov.w2_non_commutative_parts(m, s, om, os, scale_prec=True),
                (mean, sqrt, old_mean, old_sqrt), (0, 1)),
        }
        for name, (fn, inputs, diff) in cases.items():
            results = {}
            for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float32), ("cpu", torch.float64)):
                ins = [torch.tensor(np.asarray(x, np.float32), dtype=dtype, device=dev, requires_grad=i in diff)
                       for i, x in enumerate(inputs)]
                outs = fn(*ins)
                outs = outs if isinstance(outs, tuple) else (outs,)
                g = torch.Generator().manual_seed(1)
                sum((o * torch.randn(o.shape, generator=g).to(dev, dtype)).sum() for o in outs).backward()
                results[dev, dtype] = [o.detach().cpu().double() for o in outs] + [ins[i].grad.cpu().double() for i in diff]

            def err(a, b):
                return max((x - y).abs().max().item() / max(1.0, y.abs().max().item()) for x, y in zip(a, b))

            ref = results["cpu", torch.float64]
            card_err, cpu_err = err(results["cuda", torch.float32], ref), err(results["cpu", torch.float32], ref)
            worst = max(worst, card_err, cpu_err)
            worst_pair = max(worst_pair, err(results["cuda", torch.float32], results["cpu", torch.float32]))
            if not max(card_err, cpu_err) <= FULLCOV_TOL:
                fail(f"{name} at k={k} in f32 is {card_err} (card) / {cpu_err} (CPU) from f64")
    print(f"[fullcov] the full-covariance projections and their gradients at k = 6 and 12 ({batch} matrices) in f32, "
          f"card and CPU against f64 on the CPU: max |diff| / max(1, scale) = {worst:.3e} (tol {FULLCOV_TOL}); card vs "
          f"CPU in f32 {worst_pair:.3e}; phase took {time.perf_counter() - t_phase:.2f} s; on {card}")


def parity_phase(card: str, config: str, positions: dict, model: str = "") -> None:
    """The slice of `config` (with its `model` replaced where one is given) on
    a small input (4 envs, f32), the same params and normaliser on both: 3
    deterministic steps of the card, each also taken by the CPU from a copy
    of the card's state before it. The CPU's mean action on that state, and
    its reward and each `positions[name](env_state)` after stepping it with
    the card's action, within SLICE_TOL of each quantity's scale.

    The CPU also runs the 3 steps free, on its own states and actions; that
    gap is printed and not gated. On cloth it compounds: the kernel's
    few-1e-6 position gap to the plain solve becomes a 1/dt larger velocity
    observation, and the free run's actions were 3.8e-6 and 1.2e-4 of scale
    apart in two runs of one tree on the H100."""
    import torch

    from geometry_rl_torch.config import load_config, trainer_from_config
    from geometry_rl_torch.rl.obs_pipeline import obs_norm_step

    t_phase = time.perf_counter()
    small = load_config(config, overrides={
        "env": {"num_envs": 4, "kwargs": {"warmup_steps": 2}}, "algorithm": {"dtype": "float32"},
        **({"model": model} if model else {}),
    })
    config = f"{config} as {model}" if model else config
    gpu, cpu = trainer_from_config(small, device="cuda"), trainer_from_config(small, device="cpu")
    g_state = gpu.init(torch.Generator(device="cuda").manual_seed(0))
    cpu.policy.load_state_dict(gpu.policy.state_dict())
    env_state, norm_g = g_state.env_state, g_state.norm
    step_gen = torch.Generator().manual_seed(0)
    free_state = moved(env_state, "cpu")._replace(generator=torch.Generator().manual_seed(0))
    norm_c = moved(norm_g, "cpu")

    def action(trainer, norm, state):
        return trainer._policy_dist(obs_norm_step(norm, trainer.env.observe(state), update=False)[1]).mean

    def record(into, pairs):
        for name, (g, c) in pairs.items():
            into[name] = max(into[name], (g.cpu() - c).abs().max().item() / max(1.0, c.abs().max().item()))

    worst = {"action": 0.0, "reward": 0.0, **{name: 0.0 for name in positions}}
    free = dict(worst)
    with torch.no_grad():
        for _ in range(3):
            c_state = moved(env_state, "cpu")._replace(generator=step_gen)
            a_g, a_c, a_free = action(gpu, norm_g, env_state), action(cpu, norm_c, c_state), action(cpu, norm_c, free_state)
            env_state, ts_g = gpu.env.step(env_state, a_g)
            c_state, ts_c = cpu.env.step(c_state, a_g.cpu())
            free_state, ts_free = cpu.env.step(free_state, a_free)
            step_gen = c_state.generator
            record(worst, {"action": (a_g, a_c), "reward": (ts_g.reward, ts_c.reward),
                           **{name: (get(env_state), get(c_state)) for name, get in positions.items()}})
            record(free, {"action": (a_g, a_free), "reward": (ts_g.reward, ts_free.reward),
                          **{name: (get(env_state), get(free_state)) for name, get in positions.items()}})
    print(f"[parity] {config}: 4 envs, 3 deterministic steps, each from the card's state, card vs CPU: max |diff| / "
          f"max(1, max |CPU value|): " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f" (tol {SLICE_TOL}); the CPU run free (not gated): " + ", ".join(f"{k} {v:.3e}" for k, v in free.items())
          + f"; phase took {time.perf_counter() - t_phase:.2f} s; on {card}")
    if not max(worst.values()) <= SLICE_TOL:
        fail(f"the {config} slice on the card disagrees with the CPU: {worst}")


def play_phase(card: str, run_dir: str, steps: int = 100, keep: bool = False) -> None:
    """`train.play` on a run: `steps` steps, success threshold 0.1; the run
    dir is removed after unless `keep`."""
    from geometry_rl_torch.train import play

    t_phase = time.perf_counter()
    results = play.main(["--run-dir", run_dir, "--checkpoint", "checkpoints", "--episodes-steps", str(steps),
                         "--success-threshold", "0.1", "--device", "cuda"])
    for key, entry in results.items():
        if not (entry["reward"] == entry["reward"] and 0.0 <= entry["success_rate"] <= 1.0):
            fail(f"play result for checkpoint {key} is not finite: {entry}")
    print(f"[play] {os.path.basename(run_dir)}: {len(results)} checkpoints, {steps} steps each: {results}; "
          f"phase took {time.perf_counter() - t_phase:.2f} s; on {card}")
    if not keep:
        shutil.rmtree(os.path.dirname(run_dir))


def profile_phase(card: str, config: str, steps: int = 2) -> None:
    """Phases 12 and 17: `train/profile.py`'s collect window over `steps`
    control steps of `config`'s collect at full width (after a warm-up
    collect of as many steps): device kernels per control step, device busy
    ms and idle share of the window's wall time, the device time under the
    env step, the policy and the critic, and the ops and kernels with the
    most device time."""
    import torch

    from geometry_rl_torch.config import load_config, trainer_from_config
    from geometry_rl_torch.train.profile import collect_window

    t_phase = time.perf_counter()
    cfg = load_config(config)
    cfg["collector"]["frames_per_batch"] = steps * cfg["env"]["num_envs"]
    trainer = trainer_from_config(cfg, device="cuda")
    state = trainer.init(torch.Generator(device="cuda").manual_seed(0))
    stats = collect_window(trainer, state, steps, tag=f"{cfg['task']} ")
    if not stats["kernels_per_control_step"] > 0:
        fail(f"the profiler recorded no device kernels in the {cfg['task']} collect")
    print(f"[profile] {cfg['task']} collect window on {card}; phase took {time.perf_counter() - t_phase:.2f} s")


def update_profile_phase(card: str, config: str, collect_steps: int, minibatches: int = 10, overrides: tuple = ()) -> dict:
    """Phases 22 and 27: `train/profile.py`'s update window on `config` (with
    `overrides`) at full width, on a batch of `collect_steps` control steps
    (enough for `minibatches` minibatches; the window needs no whole
    iteration)."""
    import torch

    from geometry_rl_torch.config import load_config, trainer_from_config
    from geometry_rl_torch.train.cli import parse_overrides
    from geometry_rl_torch.train.profile import update_window

    t_phase = time.perf_counter()
    cfg = load_config(config, parse_overrides(overrides))
    cfg["collector"]["frames_per_batch"] = collect_steps * cfg["env"]["num_envs"]
    trainer = trainer_from_config(cfg, device="cuda")
    if trainer.num_minibatches < minibatches:
        fail(f"{collect_steps} control steps of {config} hold {trainer.num_minibatches} minibatches, {minibatches} needed")
    state = trainer.init(torch.Generator(device="cuda").manual_seed(0))
    tag = f"{config}{' ' + ' '.join(overrides) if overrides else ''}: "
    stats = update_window(trainer, state, minibatches, tag=tag)
    if not stats["kernels_per_minibatch"] > 0:
        fail(f"the profiler recorded no device kernels in the {config} update")
    print(f"[profile] {config}: update window on {card}; phase took {time.perf_counter() - t_phase:.2f} s")
    return stats


def papi_window_phase(card: str, config: str, overrides) -> dict:
    """Phase 25's second half: `train/profile.py`'s `papi_window` at full
    width: ms, device kernels and peak device memory of one call of PAPI's
    post-update steps on a collected batch."""
    import torch

    from geometry_rl_torch.config import load_config, trainer_from_config
    from geometry_rl_torch.train.cli import parse_overrides
    from geometry_rl_torch.train.profile import papi_window

    t_phase = time.perf_counter()
    cfg = load_config(config, parse_overrides(overrides))
    trainer = trainer_from_config(cfg, device="cuda")
    stats = papi_window(trainer, trainer.init(torch.Generator(device="cuda").manual_seed(0)), tag=f"{config}: ")
    if not stats["papi_kernels"] > 0:
        fail("the profiler recorded no device kernels in the PAPI steps")
    print(f"[profile] {config}: PAPI steps on {card}; phase took {time.perf_counter() - t_phase:.2f} s")
    return stats


def cloth_xpbd_phase(card: str, steps: int = 3) -> None:
    """Phase 13: the cloth env's `use_pallas_solver=False` mode (step_physics
    in plain PyTorch) against its "tiled" mode (K2's port) at full width. Both
    solvers advance the same state each step (free-running, f32 order noise
    grows ~3x a step through cloth contact); the `False` env must launch
    neither kernel."""
    import torch

    from geometry_rl_torch.config import load_config
    from geometry_rl_torch.envs import make_env
    from geometry_rl_torch.sim.cloth_solve import LAUNCHES

    t_phase = time.perf_counter()
    cfg = load_config("cloth_hanging_multi_hepi_trpl")
    B = cfg["env"]["num_envs"]
    kw = {**(cfg["env"].get("kwargs") or {}), "num_envs": B, "device": "cuda"}
    env_x = make_env("cloth_hanging", **{**kw, "use_pallas_solver": False})
    env_t = make_env("cloth_hanging", **{**kw, "use_pallas_solver": "tiled"})
    if env_x.solver_mode is not False or env_t.solver_mode != "tiled":
        fail(f"solver modes {env_x.solver_mode!r} / {env_t.solver_mode!r}, expected False / 'tiled'")
    before = dict(LAUNCHES)
    state = env_x.reset(torch.Generator(device="cuda").manual_seed(7))
    A = env_x.cfg.action_dim
    worst = {"particles": 0.0, "grippers": 0.0}
    moved_by, t_x, t_t = 0.0, 0.0, 0.0
    for t in range(steps):
        action = torch.sin(torch.arange(B * A, dtype=torch.float32, device="cuda").reshape(B, A) * 0.7 + t * 0.3)
        pre = env_x._apply_action(state.scene, action)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sx = env_x._physics(pre, state.hanger_pos)
        torch.cuda.synchronize()
        t_x += time.perf_counter() - t0
        if dict(LAUNCHES) != before:
            fail(f"the use_pallas_solver=False env launched a cloth kernel: {dict(LAUNCHES)} from {before}")
        t0 = time.perf_counter()
        st = env_t._physics(pre, state.hanger_pos)
        torch.cuda.synchronize()
        t_t += time.perf_counter() - t0
        before = dict(LAUNCHES)
        worst["particles"] = max(worst["particles"], (st.particles.pos - sx.particles.pos).abs().max().item())
        worst["grippers"] = max(worst["grippers"], (st.bodies.pos - sx.bodies.pos).abs().max().item())
        moved_by = max(moved_by, (sx.particles.pos - pre.particles.pos).abs().max().item())
        state = state._replace(scene=sx)
    print(f"[cloth-xpbd] cloth_hanging {B} envs, {steps} control steps (after the reset's {env_x.cfg.warmup_steps} warm-up "
          f"steps in mode False), mode False vs \"tiled\" from the same state each step: max |diff| particles "
          f"{worst['particles']:.3e}, grippers {worst['grippers']:.3e} (tol {SOLVE_TOL}; a step moved particles by up to "
          f"{moved_by:.3e}); mode False launched no cloth kernel; physics per control step {1e3 * t_x / steps:.1f} ms "
          f"(False) vs {1e3 * t_t / steps:.2f} ms (tiled); phase took {time.perf_counter() - t_phase:.2f} s; on {card}")
    if not max(worst.values()) <= SOLVE_TOL:
        fail(f"the cloth env's False and tiled modes disagree: {worst}")


CLOTH_CONFIG = "cloth_hanging_multi_hepi_trpl"
# one BC epoch card vs CPU: each minibatch's loss (relative) and the policy's
# mean after the epoch (relative to max(1, scale)); not the params entry by
# entry: Adam with optax's eps of 1e-8 turns a gradient entry at rounding
# level (~1e-8 where the global norm is ~1e2) into a step of up to lr = 3e-4
# of either sign
BC_TOL = 1e-4
# data parallelism against one process: tests/test_parallel.py's tolerances
DP_METRIC_ATOL, DP_METRIC_RTOL = 1e-4, 1e-3
DP_PARAM_ATOL, DP_PARAM_RTOL = 5e-5, 1e-4
DP_STATE_TOL = 1e-5
# the first minibatch step of 2 ranks against one process at full width: the
# ranks' forwards run at half the batch, where the card's f32 GEMMs round in
# another order (~1e-6 of the output after the layers), and the critic's loss
# subtracts targets from values of ~190 that differ by ~28: with the card
# deterministic (run-to-run gap 0) the gradients measured 1.96e-4 of their
# global norm and the metrics 1.96 of test_parallel's tolerance on an NVIDIA
# H100 80GB HBM3 at 700 W (PERF.md); tests/test_torch_parallel.py holds the
# tight tolerances at a small size on the CPU
DP_FIRST_GRAD_TOL = 1e-3
DP_FIRST_METRIC_SCALE = 10.0
TIMING_KEYS = ("wall_time", "train/iteration_time", "train/collect_time", "train/update_time")


def counted(obj, name: str, into: dict, key: str):
    """Wrap `obj.name` so that the cloth-kernel launches made inside its
    calls add up under `into[key]` and their seconds (each call ending in a
    device synchronize) under `into[key + "_s"]`."""
    import torch

    from geometry_rl_torch.sim.cloth_solve import LAUNCHES

    inner = getattr(obj, name)

    def wrapper(*args, **kwargs):
        before = LAUNCHES["cloth_solve"] + LAUNCHES["cloth_solve_env"]
        t0 = time.perf_counter()
        try:
            return inner(*args, **kwargs)
        finally:
            torch.cuda.synchronize()
            into[key + "_s"] = into.get(key + "_s", 0.0) + time.perf_counter() - t0
            into[key] = into.get(key, 0) + LAUNCHES["cloth_solve"] + LAUNCHES["cloth_solve_env"] - before

    setattr(obj, name, wrapper)
    return inner


def bc_phase(card: str) -> dict:
    """Phase 28: `train.bc_cli` at full width on CLOTH_CONFIG from a fresh
    init (100 steps recorded: 10,000 transitions; 5 epochs of 39 minibatches
    of 256; an eval of 100 steps at epoch 0; the final success eval), then
    `train.play` on `cloned/`. Gates: K2's port launches exactly 2 x (10 +
    100) times in the recording and in each eval, and K1's never; the dataset
    has the JAX package's keys and shapes; every `bc_loss` is finite and the
    fifth epoch's is below the first's. Then one BC epoch (4 minibatches of
    20 from 80 recorded transitions, 4 envs, f32) on the card and on the CPU
    from the same params, data and permutation: the first minibatch's
    gradients within GRAD_TOL of their global norm, each minibatch's loss and
    the policy's mean after the epoch within BC_TOL (the params' largest gap
    is printed). Returns the launch counts of the recording and the evals."""
    import numpy as np
    import torch

    from geometry_rl_torch.config import _merge, load_config, trainer_from_config
    from geometry_rl_torch.sim.cloth_solve import LAUNCHES
    from geometry_rl_torch.train import bc, bc_cli, play
    from geometry_rl_torch.train.ppo import Trainer

    t_phase = time.perf_counter()
    out = tempfile.mkdtemp(prefix="chip_smoke_bc_")
    counts = {}
    originals = [(bc, "generate_data", counted(bc, "generate_data", counts, "record")),
                 (bc, "behavior_cloning", counted(bc, "behavior_cloning", counts, "clone")),
                 (Trainer, "eval_rollout", counted(Trainer, "eval_rollout", counts, "eval_rollout")),
                 (Trainer, "eval_success", counted(Trainer, "eval_success", counts, "eval_success"))]
    LAUNCHES.update(cloth_solve=0, cloth_solve_env=0)
    try:
        t0 = time.perf_counter()
        history = bc_cli.main(["--config", CLOTH_CONFIG, "--device", "cuda", "--record-steps", "100", "--epochs", "5",
                               "--batch-size", "256", "--eval-every", "5", "--eval-steps", "100", "--success-threshold",
                               "0.1", "--out-dir", out])
        torch.cuda.synchronize()
        t_cli = time.perf_counter() - t0
    finally:
        for obj, name, inner in originals:
            setattr(obj, name, inner)
    launches = dict(LAUNCHES)
    each = 2 * (10 + 100)
    epoch_s = (counts["clone_s"] - counts["eval_rollout_s"]) / 5
    print(f"[bc] {CLOTH_CONFIG}: bc_cli took {t_cli:.2f} s: recording 100 steps {counts['record_s']:.3f} s, 5 epochs of 39 "
          f"minibatches of 256 {epoch_s:.3f} s each, eval_rollout of 100 steps {counts['eval_rollout_s']:.3f} s, eval_success "
          f"{counts['eval_success_s']:.3f} s; on {card}")
    print(f"[bc] cloth kernel launches {launches}: recording {counts.get('record')}, "
          f"eval_rollout {counts.get('eval_rollout')}, eval_success {counts.get('eval_success')} (expected {each} each); "
          f"history {history}")
    if (counts.get("record"), counts.get("eval_rollout"), counts.get("eval_success")) != (each, each, each):
        fail(f"the BC path launched {counts}, expected {each} in the recording and in each eval")
    if launches["cloth_solve_env"] != 0:
        fail(f"the BC path launched K1's port: {launches}")
    losses = [row["bc_loss"] for row in history if "bc_loss" in row]
    if len(losses) != 5 or not all(np.isfinite(losses)) or not losses[4] < losses[0]:
        fail(f"bc_loss {losses}: expected 5 finite values falling from the first epoch to the fifth")
    data = np.load(os.path.join(out, "data.npz"))
    obs_keys = sorted(k for k in data.files if k.startswith("obs_"))
    want = {"action": (10000, 12), "env_ids": (10000,)}
    if sorted(data.files) != sorted(obs_keys + list(want)) or not obs_keys:
        fail(f"data.npz holds {sorted(data.files)}")
    for k, shape in want.items():
        if data[k].shape != shape:
            fail(f"data.npz {k} has shape {data[k].shape}, expected {shape}")
    if data["env_ids"].dtype != np.int32 or any(data[k].shape[0] != 10000 for k in obs_keys):
        fail("data.npz's env_ids are not int32, or an obs group is not 10,000 rows")
    print(f"[bc] data.npz: {', '.join(f'{k} {data[k].shape} {data[k].dtype}' for k in data.files)}")
    t0 = time.perf_counter()
    results = play.main(["--run-dir", out, "--checkpoint", "cloned", "--episodes-steps", "100", "--success-threshold",
                         "0.1", "--device", "cuda"])
    print(f"[bc] play on cloned/: {results} ({time.perf_counter() - t0:.2f} s)")
    if not all(np.isfinite(e["reward"]) for e in results.values()):
        fail(f"play on the clone is not finite: {results}")
    shutil.rmtree(out)

    # one BC epoch, card vs CPU
    small = load_config(CLOTH_CONFIG, overrides=_merge({"env": {"num_envs": 4, "kwargs": {"warmup_steps": 2}}},
                                                       {"algorithm": {"dtype": "float32"}}))
    gpu, cpu = trainer_from_config(small, device="cuda"), trainer_from_config(small, device="cpu")
    state = gpu.init(torch.Generator(device="cuda").manual_seed(0))
    cpu.policy.load_state_dict(gpu.policy.state_dict())
    recorded = bc.generate_data(gpu, state, n_steps=20)
    perm = torch.as_tensor(np.random.default_rng(0).permutation(80).reshape(4, 20))
    first_grads, losses, means = {}, {}, {}
    for tr in (gpu, cpu):
        d, name = tr.device, tr.device.type
        opt = torch.optim.Adam(tr.policy.parameters(), lr=3e-4, eps=1e-8)
        tobs = {k[4:]: torch.tensor(v, device=d) for k, v in recorded.items() if k.startswith("obs_")}
        acts, ids = torch.tensor(recorded["action"], device=d), torch.tensor(recorded["env_ids"], device=d).long()
        step = opt.step

        def recording(*args, tr=tr, step=step, name=name, **kwargs):
            if name not in first_grads:
                first_grads[name] = {k: p.grad.detach().cpu().clone() for k, p in tr.policy.named_parameters()
                                     if p.grad is not None}
            return step(*args, **kwargs)

        opt.step = recording
        # the epoch, one minibatch per call so that each minibatch's loss is kept
        losses[name] = torch.stack([bc.bc_epoch(tr, opt, tobs, acts, ids, idx[None]).cpu() for idx in perm.to(d)])
        with torch.no_grad():
            means[name] = tr._policy_dist(tobs, ids).mean.cpu()
    g, gc = first_grads["cuda"], first_grads["cpu"]
    norm = torch.sqrt(sum((v ** 2).sum() for v in gc.values())).item()
    grad_err = max((g[k] - v).abs().max().item() for k, v in gc.items()) / norm
    loss_err = ((losses["cuda"] - losses["cpu"]).abs() / losses["cpu"].abs()).max().item()
    mean_err = (means["cuda"] - means["cpu"]).abs().max().item() / max(1.0, means["cpu"].abs().max().item())
    c = cpu.policy.state_dict()
    errs = {k: (v.cpu() - c[k]).abs().max().item() / max(1.0, c[k].abs().max().item()) for k, v in gpu.policy.state_dict().items()}
    worst = max(errs, key=errs.get)
    i = (gpu.policy.state_dict()[worst].cpu() - c[worst]).abs().argmax()
    print(f"[bc] one BC epoch (4 minibatches of 20, 4 envs, f32), card vs CPU: first-minibatch gradients max |diff| / "
          f"global norm = {grad_err:.3e} (tol {GRAD_TOL}); the 4 minibatch losses max relative diff {loss_err:.3e} (tol "
          f"{BC_TOL}); the policy mean on the 80 observations after the epoch, max |diff| / max(1, scale) = "
          f"{mean_err:.3e} (tol {BC_TOL}); params max |diff| / max(1, scale) = {errs[worst]:.3e} (not gated) at "
          f"{worst}[{int(i)}], whose first gradients are {g[worst].reshape(-1)[i].item():.3e} (card) and "
          f"{gc[worst].reshape(-1)[i].item():.3e} (CPU) of a global norm {norm:.3e}: Adam's eps of 1e-8 turns a "
          f"rounding-level gradient into a step of up to lr = 3e-4 of either sign; phase took "
          f"{time.perf_counter() - t_phase:.2f} s; on {card}")
    if not grad_err <= GRAD_TOL:
        fail(f"the card's BC gradients disagree with the CPU's: {grad_err}")
    if not (loss_err <= BC_TOL and mean_err <= BC_TOL):
        fail(f"the card's BC epoch disagrees with the CPU's: losses {loss_err}, policy means {mean_err}")
    return counts


def runner_phase(card: str) -> None:
    """Phase 29: `OnPolicyRunner` with its defaults (rigid_pushing, HEPi, ppo,
    256 envs x 24 steps): `learn(1)`; `save` then `load` restores bit-exactly
    (params, Adam states) after a further iteration moved them; and
    `get_inference_policy` on the card within SLICE_TOL of the CPU's on the
    same params, normaliser and observation. Neither cloth kernel launches."""
    import torch

    from geometry_rl_torch.sim.cloth_solve import LAUNCHES
    from geometry_rl_torch.train.runner import OnPolicyRunner

    t_phase = time.perf_counter()
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_runner_")
    LAUNCHES.update(cloth_solve=0, cloth_solve_env=0)
    runner = OnPolicyRunner("rigid_pushing", log_dir=log_dir, device="cuda")
    t0 = time.perf_counter()
    runner.learn(1)
    torch.cuda.synchronize()
    t_learn = time.perf_counter() - t0
    row = json.loads(open(os.path.join(log_dir, "metrics.jsonl")).readline())
    runner.save()
    saved = {k: v.clone() for k, v in runner.trainer.policy.state_dict().items()}
    saved_opt = {i: {k: v.clone() for k, v in s.items()} for i, s in runner.state.actor_opt.state_dict()["state"].items()}
    runner.learn(1)
    runner.load(os.path.join(log_dir, "checkpoints"))
    exact = all(torch.equal(v, saved[k]) for k, v in runner.trainer.policy.state_dict().items()) and all(
        torch.equal(v, saved_opt[i][k]) for i, s in runner.state.actor_opt.state_dict()["state"].items() for k, v in s.items())
    cpu = OnPolicyRunner("rigid_pushing", device="cpu")
    cpu.trainer.policy.load_state_dict(runner.trainer.policy.state_dict())
    cpu.state = cpu.state._replace(norm=moved(runner.state.norm, "cpu"))
    obs = runner.state.obs
    got, want = runner.get_inference_policy()(obs).cpu(), cpu.get_inference_policy()(moved(obs, "cpu"))
    err = (got - want).abs().max().item() / max(1.0, want.abs().max().item())
    print(f"[runner] OnPolicyRunner(rigid_pushing, hepi, ppo, 256 envs x 24 steps): learn(1) {t_learn:.2f} s, reward "
          f"{row['train/reward']:.3f}, loss_critic {row['loss_critic']:.4f}; save/load bit-exact: {exact}; inference "
          f"policy card vs CPU max |diff| / max(1, scale) = {err:.3e} (tol {SLICE_TOL}); cloth kernel launches "
          f"{dict(LAUNCHES)}; phase took {time.perf_counter() - t_phase:.2f} s; on {card}")
    if not exact:
        fail("the runner's load did not restore its saved params and Adam state bit-exactly")
    if not err <= SLICE_TOL or not all(abs(v) < float("inf") for k, v in row.items() if k != "train/reward"):
        fail(f"the runner's inference policy disagrees with the CPU's ({err}) or its metrics are not finite: {row}")
    if LAUNCHES != {"cloth_solve": 0, "cloth_solve_env": 0}:
        fail(f"the rigid runner launched a cloth kernel: {dict(LAUNCHES)}")
    shutil.rmtree(log_dir)


def render_phase(card: str, steps: int = 100) -> int:
    """Phase 30: `collect_frames` of env 0 of CLOTH_CONFIG at full width for
    `steps` deterministic steps: K2's port launches exactly 2 x (10 + steps)
    times; each step's snapshot (grippers, particles, hook, task distance)
    within SLICE_TOL of scale of the CPU's, which steps env 0 of the card's
    state before that step with the card's action; the rollout stops before
    env 0's first episode end. Then a GIF of 20 steps where matplotlib is
    installed; where it is not, its ImportError is printed. Returns the
    launches."""
    import numpy as np
    import torch

    from geometry_rl_torch.config import load_config, trainer_from_config
    from geometry_rl_torch.envs import make_env
    from geometry_rl_torch.sim.cloth_solve import LAUNCHES
    from geometry_rl_torch.train.render import collect_frames, record_rollout

    t_phase = time.perf_counter()
    cfg = load_config(CLOTH_CONFIG)
    trainer = trainer_from_config(cfg, device="cuda")
    state = trainer.init(torch.Generator(device="cuda").manual_seed(0))
    env = trainer.env
    taken = []
    step = env.step

    def recording(s, a):
        taken.append((moved(s, "cpu"), a[:1].cpu()))  # env 0's state before the step, and its action
        return step(s, a)

    env.step = recording
    LAUNCHES.update(cloth_solve=0, cloth_solve_env=0)
    try:
        t0 = time.perf_counter()
        frames = collect_frames(trainer, state, steps)  # timed with this check's per-step copies to the host
        t_frames = time.perf_counter() - t0
    finally:
        del env.step
    launches = LAUNCHES["cloth_solve"]
    expected = 2 * (env.cfg.warmup_steps + steps)
    cpu_env = make_env(cfg["task"], num_envs=1, device="cpu", **(cfg["env"].get("kwargs") or {}))
    worst = {"bodies": 0.0, "particles": 0.0, "hook": 0.0, "task_distance": 0.0}
    for t, frame in enumerate(frames):
        s, a = taken[t]
        one = first_envs(s, 1)._replace(generator=torch.Generator().manual_seed(t))
        nxt, ts = cpu_env.step(one, a)
        h = nxt.hanger_pos[0].numpy()
        cpu_frame = {"bodies": nxt.scene.bodies.pos[0].numpy(), "particles": nxt.scene.particles.pos[0].numpy(),
                     "hook": np.stack([h, h + np.array([0.0, 2 * cpu_env.cfg.hanger_half_len, 0.0])]),
                     "task_distance": ts.info["object_target_distance"][0].item()}
        for k, ref in cpu_frame.items():
            ref = np.asarray(ref)
            worst[k] = max(worst[k], np.abs(np.asarray(frame[k]) - ref).max() / max(1.0, np.abs(ref).max()))
    print(f"[render] collect_frames of env 0, {CLOTH_CONFIG} at {env.cfg.num_envs} envs: {len(frames)} frames of {steps} "
          f"steps ({'stopped before the episode end' if len(frames) < steps else 'no episode end'}) in "
          f"{t_frames:.2f} s; K2's port "
          f"{launches} launches (expected {expected}); each frame vs the CPU's step from the card's state, max |diff| / "
          f"max(1, scale): {', '.join(f'{k} {v:.3e}' for k, v in worst.items())} (tol {SLICE_TOL}); on {card}")
    if launches != expected or LAUNCHES["cloth_solve_env"] != 0:
        fail(f"the render path launched {dict(LAUNCHES)}, expected cloth_solve {expected}")
    if not frames or max(worst.values()) > SLICE_TOL:
        fail(f"the frames disagree with the CPU's steps: {worst}")
    path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_render_"), "episode.gif")
    try:
        t0 = time.perf_counter()
        record_rollout(trainer, state, path, n_steps=20)
        print(f"[render] wrote {path}: {os.path.getsize(path)} bytes, 20 steps, {time.perf_counter() - t0:.2f} s")
    except ImportError as e:
        print(f"[render] no GIF: {e}")
    shutil.rmtree(os.path.dirname(path))
    print(f"[render] phase took {time.perf_counter() - t_phase:.2f} s")
    return launches


def float_tensors(tree) -> list:
    """The floating-point tensors of a tree of tuples and lists, in order."""
    import torch

    if torch.is_tensor(tree):
        return [tree] if tree.is_floating_point() else []
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in float_tensors(x)]
    return []


def first_envs(tree, n: int):
    """Every tensor of a NamedTuple tree cut to its first `n` envs."""
    import torch

    if torch.is_tensor(tree):
        return tree[:n]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(first_envs(t, n) for t in tree))
    return tree


def dp_phase(card: str) -> dict:
    """Phase 31: env-axis data parallelism on one card. First the env alone:
    rank 1 of 2's 50 envs step as rows 50..100 of the one-process env (3
    steps from one seed with the same actions, within DP_STATE_TOL). Then two
    processes on cuda:0 with gloo (NCCL refuses two ranks on one device)
    train one iteration of CLOTH_CONFIG at 100 envs, 2 x 50, in f32 with 1
    update epoch (for time, as phases 19-20), beside two one-process runs of
    the same config and seed, none with PyTorch's deterministic algorithms.
    Gated against the first one-process run, with `tests/test_parallel.py`'s
    tolerances: the collect (its metrics within
    DP_METRIC_ATOL + DP_METRIC_RTOL |a|, the env's float state within
    DP_STATE_TOL); the first minibatch step, its gradients all-reduced,
    within DP_FIRST_GRAD_TOL of their global norm and its metrics within
    DP_FIRST_METRIC_SCALE of that tolerance; the second one-process run
    equal to the first, at its first minibatch step and after the whole
    update (metrics, params and env state). 2 ranks against one process
    after the whole 50-step update: printed, not gated (Adam compounds the
    first step's rounding gap). K2's port launches 2 x (10 + 100) times in every
    process; the 2-rank checkpoint (the whole env state, gathered) restores
    in one process. Then a one-rank NCCL launch through the CLI trains 1
    iteration. Returns the launch counts per process."""
    import glob

    import torch

    from geometry_rl_torch.config import load_config, trainer_from_config
    from geometry_rl_torch.train.checkpoint import restore_checkpoint

    from geometry_rl_torch.envs import make_env
    from geometry_rl_torch.parallel.mesh import env_rows

    t_phase = time.perf_counter()
    # the env part alone: rank 1's 50 envs against the one-process env's rows 50..100, from one seed and the same actions
    kwargs = load_config(CLOTH_CONFIG)["env"].get("kwargs") or {}
    full = make_env("cloth_hanging", num_envs=100, device="cuda", **kwargs)
    half = make_env("cloth_hanging", num_envs=50, device="cuda", rows=env_rows(100, 1, 2), **kwargs)
    s_full, s_half = (e.reset(torch.Generator(device="cuda").manual_seed(5)) for e in (full, half))
    g = torch.Generator(device="cuda").manual_seed(6)
    for _ in range(3):
        action = torch.randn((100, full.cfg.action_dim), generator=g, device="cuda")
        s_full, _ = full.step(s_full, action)
        s_half, _ = half.step(s_half, action[50:])
    env_gap = max((a - b[50:]).abs().max().item() for a, b in zip(float_tensors(s_half), float_tensors(s_full)))
    print(f"[dp] the env of rank 1 of 2 (50 envs) against rows 50..100 of the one-process env, 3 steps from one seed "
          f"with the same actions: max |diff| {env_gap:.3e} (tol {DP_STATE_TOL})")
    if not env_gap <= DP_STATE_TOL:
        fail(f"rank 1's env is not the row block of the one-process env: {env_gap}")
    root = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    overrides = ["collector.total_frames=10000", "algorithm.objective.ppo_epochs=1", "algorithm.dtype=float32",
                 "logger.checkpoint.save_interval=1"]
    def start(name, backend=None, rank=None, world=None, port=None):
        env = dict(os.environ, FIRST_MINIBATCH=os.path.join(root, f"first_{name}_{rank or 0}.pt"))
        if rank is not None:
            env.update(GEOMRL_COORDINATOR=f"localhost:{port}", GEOMRL_NUM_PROCESSES=str(world), GEOMRL_PROCESS_ID=str(rank))
        cmd = [sys.executable, "-c", DP_WORKER, "--config", CLOTH_CONFIG, "--device", "cuda",
               *(["--dist-backend", backend] if backend else []), "--override", *overrides, f"logger.log_dir={root}/{name}"]
        return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=HERE)

    def finish(procs, timeout=600):
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=timeout)[0].decode())
        finally:
            for p in procs:  # never leave a rank blocked in a collective
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, out in zip(procs, outs):
            if p.returncode != 0:
                raise RuntimeError(f"chip_smoke: a data-parallel process exited {p.returncode}:\n{out[-4000:]}")
        return [json.loads(out.rsplit("LAUNCHES ", 1)[1].splitlines()[0]) for out in outs], outs

    def run_dir(name):
        runs = glob.glob(os.path.join(root, name, "*", "metrics.jsonl"))
        if len(runs) != 1:
            fail(f"{name}: expected one run, found {runs}")
        return os.path.dirname(runs[0])

    port = free_port()
    t0 = time.perf_counter()
    launches, outs = finish([start("mh", "gloo", r, 2, port) for r in range(2)] + [start("one"), start("again")])
    t_runs = time.perf_counter() - t0
    expected = {"cloth_solve": 2 * (10 + 100), "cloth_solve_env": 0}
    mh, one, again = run_dir("mh"), run_dir("one"), run_dir("again")

    def rows_of(d):
        return [json.loads(line) for line in open(os.path.join(d, "metrics.jsonl"))]

    def excess_of(got, want):
        """|got - want| over the tolerance; NaN on both sides (no episode ended) agrees."""
        if want != want or got != got:
            return 0.0 if want != want and got != got else float("inf")
        return abs(got - want) / (DP_METRIC_ATOL + DP_METRIC_RTOL * abs(want))

    def compare(d, ref):
        """Run `d` against `ref` after the whole update: (the 5 worst metrics as (excess, name, value, reference),
        the params' worst excess over their tolerance and its tensor, the env state's max |diff|)."""
        excess = sorted(((excess_of(b[k], v), k, b[k], v) for a, b in zip(rows_of(ref), rows_of(d)) for k, v in a.items()
                         if k not in TIMING_KEYS), reverse=True)
        ck, ck_ref = (torch.load(os.path.join(x, "checkpoints", "0", "state.pt"), map_location="cpu", weights_only=True)
                      for x in (d, ref))
        params = max((((ck[p][k] - v).abs() / (DP_PARAM_ATOL + DP_PARAM_RTOL * v.abs())).max().item(), f"{p}.{k}")
                     for p in ("policy", "critic") for k, v in ck_ref[p].items())
        state = max((a - b).abs().max().item() for a, b in zip(float_tensors(ck["state"]["env_state"]),
                                                               float_tensors(ck_ref["state"]["env_state"])))
        return excess[:5], params, state

    def describe(excess, params, state):
        worst = ", ".join(f"{k} {got:.6g} vs {ref:.6g} ({e:.3f})" for e, k, got, ref in excess)
        return (f"metrics at most {excess[0][0]:.3f} of their tolerance ({worst}); params at most {params[0]:.3f} of "
                f"theirs ({params[1]}); env float state max |diff| {state:.3e}")

    def first_gap(name):
        """The first minibatch step of run `name` (rank 0's, its gradients all-reduced) against the one-process
        run's: (gradients' max |diff| over their global norm, metrics' worst excess over their tolerance)."""
        got, ref = (torch.load(os.path.join(root, f"first_{n}_0.pt"), map_location="cpu", weights_only=True)
                    for n in (name, "one"))
        norm = torch.sqrt(sum((g ** 2).sum() for g in ref["grads"].values())).item()
        gaps = sorted((((got["grads"][k] - g).abs().max().item() / norm, k, got["grads"][k].reshape(-1)[(got["grads"][k] - g).abs().argmax()].item(),
                        g.reshape(-1)[(got["grads"][k] - g).abs().argmax()].item(), g.abs().max().item()) for k, g in ref["grads"].items()), reverse=True)
        metrics = sorted(((excess_of(got["metrics"][k].item(), v.item()), k, got["metrics"][k].item(), v.item())
                          for k, v in ref["metrics"].items()), reverse=True)
        print(f"[dp] first minibatch of {name} vs one: worst gradients (gap / norm {norm:.4g}, tensor, got, want, tensor max) "
              f"{[(f'{e:.3e}', k, f'{a:.6g}', f'{b:.6g}', f'{m:.4g}') for e, k, a, b, m in gaps[:3]]}; worst metrics "
              f"{[(f'{e:.3f}', k, f'{a:.7g}', f'{b:.7g}') for e, k, a, b in metrics[:3]]}")
        return gaps[0][0], metrics[0][0]

    dp_cmp, rerun_cmp = compare(mh, one), compare(again, one)
    dp_first, rerun_first = first_gap("mh"), first_gap("again")
    # the metrics the collect alone decides: they do not depend on the update's compounding
    collect_keys = ("train/reward", "train/episodes", "train/explained_variance", "train/frames")
    collect_err = max(excess_of(b[k], a[k]) for a, b in zip(rows_of(one), rows_of(mh)) for k in collect_keys)
    cfg = load_config(None, json.load(open(os.path.join(mh, "hparams.json"))))
    fresh = trainer_from_config(cfg, device="cuda")
    restored = restore_checkpoint(os.path.join(mh, "checkpoints"), fresh, fresh.init(torch.Generator(device="cuda").manual_seed(0)), 0)
    ck_mh = torch.load(os.path.join(mh, "checkpoints", "0", "state.pt"), map_location="cpu", weights_only=True)
    restore_ok = torch.equal(restored.env_state.scene.particles.pos.cpu(), ck_mh["state"]["env_state"][0][1][0])
    r0, r1 = rows_of(mh)[0], rows_of(one)[0]
    print(f"[dp] {CLOTH_CONFIG}, 100 envs, f32, 1 update epoch: 2 gloo ranks x 50 envs on cuda:0 and two one-process "
          f"runs x 100, all four at once in {t_runs:.2f} s; 2 ranks: iteration {r0['train/iteration_time']:.3f} s = "
          f"collect {r0['train/collect_time']:.3f} s + update {r0['train/update_time']:.3f} s; one process: "
          f"{r1['train/iteration_time']:.3f} s = {r1['train/collect_time']:.3f} + {r1['train/update_time']:.3f} s; "
          f"launches per process {launches} (expected {expected} each); the 2-rank checkpoint restores in one process: "
          f"{restore_ok}; on {card}")
    print(f"[dp] 2 ranks vs one process: the collect's metrics at most {collect_err:.3f} of their tolerance, env float "
          f"state max |diff| {dp_cmp[2]:.3e} (tol {DP_STATE_TOL}); the first minibatch step: gradients max |diff| / "
          f"global norm {dp_first[0]:.3e} (tol {DP_FIRST_GRAD_TOL}), metrics at most {dp_first[1]:.3f} of their "
          f"tolerance (tol {DP_FIRST_METRIC_SCALE})")
    print(f"[dp] after the 50-step update (not gated: each step compounds the rounding of the last): 2 ranks vs one "
          f"process: {describe(*dp_cmp)}")
    rerun_equal = rerun_cmp[0][0][0] == 0.0 and rerun_cmp[1][0] == 0.0 and rerun_cmp[2] == 0.0
    print(f"[dp] one process vs the same run again, without PyTorch's deterministic algorithms (gated: equal after "
          f"the whole update): {describe(*rerun_cmp)}; first minibatch step: gradients {rerun_first[0]:.3e}, metrics "
          f"{rerun_first[1]:.3f}; equal {rerun_equal}")
    if any(n != expected for n in launches):
        fail(f"the data-parallel processes launched {launches}, expected {expected} each")
    if not (collect_err <= 1.0 and dp_cmp[2] <= DP_STATE_TOL and dp_first[0] <= DP_FIRST_GRAD_TOL
            and dp_first[1] <= DP_FIRST_METRIC_SCALE and rerun_first == (0.0, 0.0) and rerun_equal and restore_ok):
        fail(f"2 ranks disagree with one process: collect metrics {collect_err}, env state {dp_cmp[2]}, first "
             f"minibatch gradients {dp_first[0]} and metrics {dp_first[1]} (one process against itself: "
             f"{rerun_first}, equal after the update {rerun_equal}), restore {restore_ok}")
    t0 = time.perf_counter()
    (nccl_launches,), (out,) = finish([start("nccl", None, 0, 1, free_port())])
    row = json.loads(open(os.path.join(run_dir("nccl"), "metrics.jsonl")).readline())
    print(f"[dp] one-rank NCCL launch through the CLI: {time.perf_counter() - t0:.2f} s, iteration "
          f"{row['train/iteration_time']:.3f} s, reward {row['train/reward']:.3f}, launches {nccl_launches}; "
          f"{[line for line in out.splitlines() if line.startswith('data-parallel')]}")
    if nccl_launches != expected or "(nccl)" not in out or not all(abs(v) < float("inf") for v in row.values()):
        fail(f"the NCCL launch: {nccl_launches}, {out[-2000:]}")
    shutil.rmtree(root)
    print(f"[dp] phase took {time.perf_counter() - t_phase:.2f} s")
    return {"rank": launches[0], "one": launches[2], "nccl": nccl_launches}


# one process of phase 31: the training CLI as a user runs it (no
# deterministic algorithms: the message sums follow fixed orders), the first
# minibatch step's gradients (all-reduced, under data parallelism) and metrics
# saved to $FIRST_MINIBATCH, then the cloth kernels' launch counts printed
DP_WORKER = """
import json, os, sys, torch
from geometry_rl_torch.sim.cloth_solve import LAUNCHES
from geometry_rl_torch.train import cli, ppo
step = ppo.Trainer._minibatch_step
def first(self, state, mb, *args, **kwargs):
    out = step(self, state, mb, *args, **kwargs)
    if not os.path.exists(os.environ["FIRST_MINIBATCH"]):
        grads = {f"{m}.{n}": p.grad.cpu() for m in ("policy", "critic") for n, p in getattr(self, m).named_parameters()
                 if p.grad is not None}
        torch.save({"grads": grads, "metrics": {k: v.cpu() for k, v in out[0].items()}}, os.environ["FIRST_MINIBATCH"])
    return out
ppo.Trainer._minibatch_step = first
cli.main(sys.argv[1:])
print("LAUNCHES " + json.dumps(LAUNCHES))
"""


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def smoke_env_phase(card: str, num_envs: int = 4, steps: int = 3) -> dict:
    """Phase 32: `tools.smoke_env` on every task on the card: the last
    step's observations finite and on the card; K2's port launches exactly
    2 substeps x (10 warm-up steps + `steps`) times on cloth_hanging (solver
    mode "auto"), neither kernel on the other tasks. Returns the launch
    counts by task."""
    import contextlib
    import io

    import torch

    from geometry_rl_torch.sim.cloth_solve import LAUNCHES
    from geometry_rl_torch.tools import smoke_env

    t_phase = time.perf_counter()
    counts = {}
    for task in smoke_env.TASKS:
        out = io.StringIO()
        LAUNCHES.update(cloth_solve=0, cloth_solve_env=0)
        with contextlib.redirect_stdout(out):
            env, _, ts = smoke_env.main(["--task", task, "--num-envs", str(num_envs), "--steps", str(steps), "--device", "cuda"])
        torch.cuda.synchronize()
        counts[task] = dict(LAUNCHES)
        expected = {"cloth_solve": 2 * (10 + steps) if task == "cloth_hanging" else 0, "cloth_solve_env": 0}
        lines = out.getvalue().splitlines()
        print(f"[smoke_env] {task}: {lines[0]}; {len(env.obs_spec.names)} observation groups; {lines[-2]}; "
              f"cloth kernel launches {counts[task]} (expected {expected})")
        for group, v in ts.obs.items():
            if v.device.type != "cuda" or not torch.isfinite(v).all():
                fail(f"smoke_env {task}: observation group {group} is on {v.device} or not finite")
        if lines[-1] != "OK" or not all(line.endswith("obs finite True") for line in lines if line.startswith("step ")):
            fail(f"smoke_env {task} printed {lines[-4:]}")
        if counts[task] != expected:
            fail(f"smoke_env {task} launched {counts[task]}, expected {expected}")
    print(f"[smoke_env] phase took {time.perf_counter() - t_phase:.2f} s; on {card}")
    return counts


def eval_breakdown_phase(card: str, run_dir: str) -> dict:
    """Phase 33: `tools.eval_breakdown --episodes 1` on phase 10's
    full-width rigid_insertion run: every shape reported, the per-shape
    episodes sum to the overall count, every value finite, neither cloth
    kernel launched. Returns the report (phase 35 makes it again)."""
    import math

    from geometry_rl_torch.envs.rigid import SHAPE_NAMES
    from geometry_rl_torch.sim.cloth_solve import LAUNCHES
    from geometry_rl_torch.tools import eval_breakdown

    t_phase = time.perf_counter()
    LAUNCHES.update(cloth_solve=0, cloth_solve_env=0)
    report = eval_breakdown.main(["--run-dir", run_dir, "--checkpoint", "checkpoints", "--episodes", "1",
                                  "--out", os.path.join(run_dir, "eval_breakdown.json"), "--device", "cuda"])
    per_shape, overall = report["per_shape"], report["overall"]
    seconds = time.perf_counter() - t_phase
    print(f"[eval_breakdown] {os.path.basename(run_dir)}: overall {overall}; per shape "
          + ", ".join(f"{k} {v['episodes']} ep {v['success_rate']:.4f} at {v['mean_final_distance']:.4f}" for k, v in per_shape.items())
          + f"; cloth kernel launches {dict(LAUNCHES)}; phase took {seconds:.2f} s; on {card}")
    if sorted(per_shape) != sorted(SHAPE_NAMES):
        fail(f"eval_breakdown reported the shapes {sorted(per_shape)}, expected {sorted(SHAPE_NAMES)}")
    if sum(v["episodes"] for v in per_shape.values()) != overall["episodes"] or overall["episodes"] <= 0:
        fail(f"eval_breakdown's per-shape episodes do not sum to overall's {overall['episodes']}")
    values = [v for entry in (overall, *per_shape.values()) for v in entry.values()]
    if not all(math.isfinite(v) for v in values):
        fail(f"eval_breakdown reported non-finite values: {report}")
    if any(LAUNCHES.values()):
        fail(f"eval_breakdown on rigid_insertion launched {dict(LAUNCHES)}")
    return report


# phase 35's configurations, each at its full width: (config, overrides)
REPRO_CONFIGS = (
    ("cloth_hanging_multi_hepi_trpl", ()),  # solver mode "auto": K2's port
    ("cloth_hanging_multi_hepi_trpl", ("env.kwargs.use_pallas_solver=true",)),  # K1's port
    (RIGID_CONFIG, ()),
    (ROPE_CONFIG, ()),
    ("cloth_hanging_multi_empn_trpl", ()),
    ("rigid_insertion_multi_transformer_trpl", ()),
    ("rigid_insertion_two_agents_multi_hepi_trpl", ()),
    # the XPBD velocity pass, in the JAX package's material learn-check setting (scripts/r3_queue.sh)
    ("rigid_pushing_multi_hepi_trpl", ("env.kwargs.dynamic_friction_scale=1.0",)),
)
REPRO_STEPS = 10  # control steps per collect: 5 to 10 minibatches of the update's one epoch


def all_tensors(tree) -> list:
    """Every tensor of a tree of tuples, lists and dicts, in order."""
    import torch

    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in all_tensors(x)]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in all_tensors(tree[k])]
    return []


def same_bits(a, b) -> bool:
    """Equal in shape, type and every value; NaN equals NaN (rigid rewards are NaN while no episode ends)."""
    import torch

    if not (torch.is_tensor(a) and torch.is_tensor(b)):
        return a == b or (a != a and b != b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    return torch.equal(a, b)


def short_run(config: str, overrides=(), device: str = "cuda") -> dict:
    """One `train_iteration` of `config` at its full width and in its dtype,
    from its seed, cut in depth to REPRO_STEPS control steps (warm-up steps
    included as configured) and one update epoch. Returns what a run
    decides: every metric but the times, the params, the Adam states and the
    env state's tensors."""
    import torch

    from geometry_rl_torch.config import load_config, trainer_from_config
    from geometry_rl_torch.train.cli import parse_overrides

    cfg = load_config(config, parse_overrides(list(overrides)))
    cfg["collector"]["frames_per_batch"] = REPRO_STEPS * cfg["env"]["num_envs"]
    cfg["algorithm"]["objective"]["ppo_epochs"] = 1
    trainer = trainer_from_config(cfg, device=device)
    state = trainer.init(torch.Generator(device=device).manual_seed(cfg["seed"]))
    state, metrics = trainer.train_iteration(state)
    out = {f"metric {k}": v for k, v in metrics.items() if k not in TIMING_KEYS}
    for part in ("policy", "critic"):
        out.update({f"{part} {k}": v for k, v in getattr(trainer, part).state_dict().items()})
    for opt in ("actor_opt", "critic_opt"):
        for i, entry in getattr(state, opt).state_dict()["state"].items():
            out.update({f"{opt} {i} {k}": v for k, v in entry.items()})
    out.update({f"env state {i}": t for i, t in enumerate(all_tensors(state.env_state))})
    out.update({f"normaliser {i}": t for i, t in enumerate(all_tensors(state.norm))})
    return out


def differing(a: dict, b: dict) -> list:
    return sorted(k for k in a.keys() | b.keys() if k not in a or k not in b or not same_bits(a[k], b[k]))


def repro_phase(card: str, rigid_run=None, breakdown=None) -> None:
    """Phase 35: bit-reproducibility on the card, without PyTorch's
    deterministic algorithms. Each of REPRO_CONFIGS twice from one seed
    (`short_run`): every metric, param, Adam state and env state tensor the
    same. `tools.eval_breakdown` again on phase 10's run: the same report as
    phase 33's. Then, in one child process (with the CUBLAS_WORKSPACE_CONFIG
    that PyTorch's deterministic mode demands), cloth and rigid HEPi once
    without and once with `torch.use_deterministic_algorithms(True,
    warn_only=True)`: the same bits and no warning, so no op of the path
    swaps its implementation under the mode, or has no deterministic one.
    Removes phase 10's run dir."""
    import torch

    t_phase = time.perf_counter()
    for config, overrides in REPRO_CONFIGS:
        t0 = time.perf_counter()
        first, second = short_run(config, overrides), short_run(config, overrides)
        diff = differing(first, second)
        name = config + "".join(f" {o}" for o in overrides)
        print(f"[repro] {name}: two runs from one seed ({REPRO_STEPS} control steps, one update epoch) in "
              f"{time.perf_counter() - t0:.2f} s: {len(first)} tensors and metrics, {len(diff)} differ {diff[:6]}; "
              f"reward {float(first['metric train/reward']):.6g} / {float(second['metric train/reward']):.6g}")
        if diff:
            fail(f"two runs of {name} from one seed differ in {diff[:10]}")
        del first, second
        torch.cuda.empty_cache()
    if rigid_run is not None and breakdown is not None:
        from geometry_rl_torch.tools import eval_breakdown

        t0 = time.perf_counter()
        again = eval_breakdown.main(["--run-dir", rigid_run, "--checkpoint", "checkpoints", "--episodes", "1",
                                     "--out", os.path.join(rigid_run, "eval_breakdown_again.json"), "--device", "cuda"])
        print(f"[repro] tools.eval_breakdown again on {os.path.basename(rigid_run)} ({time.perf_counter() - t0:.2f} s): "
              f"the same report as phase 33's: {again == breakdown}")
        if again != breakdown:
            fail(f"two eval_breakdown reports of one run differ: {breakdown} vs {again}")
        shutil.rmtree(os.path.dirname(rigid_run))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", DET_WORKER], capture_output=True, text=True, cwd=HERE, timeout=900,
                          env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8"))
    if proc.returncode != 0:
        fail(f"the deterministic-mode worker exited {proc.returncode}:\n{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    else:
        result = json.loads(proc.stdout.rsplit("DET ", 1)[1].splitlines()[0])
        for config, r in result.items():
            print(f"[repro] {config} without and with torch.use_deterministic_algorithms(True) in one process "
                  f"({time.perf_counter() - t0:.2f} s for both configs): {r['tensors']} tensors and metrics, "
                  f"{len(r['differ'])} differ {r['differ'][:6]}; warnings under the mode: {r['warned'] or 'none'}")
            if r["differ"] or r["warned"]:
                fail(f"{config} differs under PyTorch's deterministic algorithms: {r}")
    print(f"[repro] phase took {time.perf_counter() - t_phase:.2f} s; on {card}")


# phase 35's child: cloth and rigid HEPi without and with PyTorch's
# deterministic algorithms, in one process
DET_WORKER = """
import json, warnings, torch
import chip_smoke
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
out = {}
for config in ("cloth_hanging_multi_hepi_trpl", chip_smoke.RIGID_CONFIG):
    off = chip_smoke.short_run(config)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            on = chip_smoke.short_run(config)
    finally:
        torch.use_deterministic_algorithms(False)
    warned = sorted({str(w.message)[:300] for w in caught if "determinis" in str(w.message)})
    out[config] = {"tensors": len(off), "differ": chip_smoke.differing(off, on), "warned": warned}
print("DET " + json.dumps(out))
"""


def learn_check_phase(card: str, iterations: int = 2) -> dict:
    """Phase 34: `tools.learn_check` on cloth_hanging at the cloth config's
    width (100 envs, minibatches of 200), `iterations` iterations: finite
    rows with the JAX script's keys and a `SUMMARY` line; K2's port launches
    exactly 2 substeps x `iterations` x 100 steps (the tool's env has no
    warm-up steps), K1's never. Returns the launch counts."""
    import contextlib
    import io

    import torch

    from geometry_rl_torch.sim.cloth_solve import LAUNCHES
    from geometry_rl_torch.tools import learn_check

    t_phase = time.perf_counter()
    out = io.StringIO()
    LAUNCHES.update(cloth_solve=0, cloth_solve_env=0)
    with contextlib.redirect_stdout(out):
        learn_check.main(["--task", "cloth_hanging", "--num-envs", "100", "--mini-batch", "200",
                          "--iterations", str(iterations), "--device", "cuda"])
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    expected = {"cloth_solve": 2 * iterations * 100, "cloth_solve_env": 0}
    lines = out.getvalue().splitlines()
    for line in lines:
        print(f"[learn_check] {line}")
    rows = [json.loads(line) for line in lines if line.startswith("{")]
    summary = [line for line in lines if line.startswith("SUMMARY ")]
    print(f"[learn_check] cloth kernel launches {launches} (expected {expected}); phase took "
          f"{time.perf_counter() - t_phase:.2f} s; on {card}")
    keys = ["iter", "reward", "kl", "ESS", "entropy", "loss_critic", "explained_var", "it_time"]
    if len(rows) != iterations or any(list(r) != keys for r in rows):
        fail(f"learn_check printed the rows {rows}, expected {iterations} with the keys {keys}")
    if not all(isinstance(v, (int, float)) and abs(v) < float("inf") for r in rows for v in r.values()):
        fail(f"learn_check printed non-finite rows: {rows}")
    if len(summary) != 1:
        fail(f"learn_check printed {len(summary)} SUMMARY lines")
    if launches != expected:
        fail(f"learn_check on cloth_hanging launched {launches}, expected {expected}")
    return launches


def new_phases(card: str, only=None, rigid_run=None) -> dict:
    """Phases 28-35 (those in `only`, where given), each printing its
    seconds; returns their launch counts. Phase 33 reads phase 10's run
    (`rigid_run`); without it, it trains one as phase 10 does. Phase 35
    makes phase 33's report again, and runs phase 33 for that."""
    t0 = time.perf_counter()
    out = {}
    if not only or 28 in only:
        out["bc"] = bc_phase(card)  # ---- 28. behaviour cloning at full width
    if not only or 29 in only:
        runner_phase(card)  # ---- 29. the OnPolicyRunner workflow
    if not only or 30 in only:
        out["render"] = render_phase(card)  # ---- 30. rollout frames on the card
    if not only or 31 in only:
        out["dp"] = dp_phase(card)  # ---- 31. data parallelism on one card
    print(f"[new] phases 28-31 took {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    if not only or 32 in only:
        out["smoke_env"] = smoke_env_phase(card)  # ---- 32. tools.smoke_env on every task
    breakdown = None
    if not only or 33 in only or 35 in only:
        if rigid_run is None:
            rigid_run, _ = train_phase(card, RIGID_CONFIG, ["collector.total_frames=100000"],
                                       {"cloth_solve": 0, "cloth_solve_env": 0})
        breakdown = eval_breakdown_phase(card, rigid_run)  # ---- 33. tools.eval_breakdown at full width
    if not only or 34 in only:
        out["learn_check"] = learn_check_phase(card)  # ---- 34. tools.learn_check through K2's port
    print(f"[new] phases 32-34 took {time.perf_counter() - t0:.2f} s")
    if only and 15 in only:  # phase 15b alone, on each HEPi family's update in a short run
        calls = {}
        for family, config in (("cloth", "cloth_hanging_multi_hepi_trpl"), ("rigid", RIGID_CONFIG), ("rope", ROPE_CONFIG)):
            with LargestSegmentCall(calls, family):
                short_run(config)
        segment_kernel_phase(card, calls)
    if not only or 35 in only:
        repro_phase(card, rigid_run, breakdown)  # ---- 35. two runs from one seed give the same bits
    elif rigid_run is not None:
        shutil.rmtree(os.path.dirname(rigid_run))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check runs on a CUDA card only", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "geometry_rl_torch")):
        print("chip_smoke: geometry_rl_torch/ is not beside this script; run it from the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)

    # ---- 1. device --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    card = smi
    print(f"[device] {card}")
    print(f"[device] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)

    from concurrent.futures import ThreadPoolExecutor

    from geometry_rl_torch.config import load_config, trainer_from_config
    from geometry_rl_torch.cuda_build import BUILD_INFO, BUILD_SECONDS, load_library
    from geometry_rl_torch.envs import make_env
    from geometry_rl_torch.sim.cloth_solve import (
        LAUNCHES,
        cloth_position_solve_cuda,
        cloth_position_solve_env_cuda,
        cloth_position_solve_ref,
        solve_cost,
    )

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:  # one nvcc per source, all at once
        list(pool.map(load_library, LIBRARIES))
    print(f"[build] " + ", ".join(f"{n}: {BUILD_SECONDS[n]:.2f} s compiling" for n in LIBRARIES)
          + f"; {time.perf_counter() - t0:.2f} s in all")
    for lib in LIBRARIES:
        for kernel, info in BUILD_INFO.get(lib, {}).items():
            print(f"[build] {lib}: {kernel}: " + ", ".join(f"{k} {v}" for k, v in info.items()))
        info = BUILD_INFO.get(lib, {})
        names = main_path_kernels(lib, info)
        if not names or not all("registers" in info[k] for k in names):
            fail(f"ptxas reported nothing for {MAIN_PATH_KERNELS[lib]}")
        for k in names:
            if info[k].get("spill_store_bytes", 0) or info[k].get("spill_load_bytes", 0):
                fail(f"{k} spills registers: {info[k]}")

    if "--new-phases" in sys.argv:  # phases 28-35 alone (or those listed after it), for work on them; no result line
        listed = sys.argv[sys.argv.index("--new-phases") + 1:]
        new_phases(card, {int(p) for p in listed[0].split(",")} if listed and listed[0][0].isdigit() else None)
        return 1 if FAILURES else 0

    # ---- 3. kernels vs plain version ---------------------------------------
    t_phase = time.perf_counter()
    kernels = {"cloth_solve": cloth_position_solve_cuda, "cloth_solve_env": cloth_position_solve_env_cuda}
    kernel_stats = {}
    for B, self_collision in ((100, False), (4, True), (1000, False)):
        env = make_env("cloth_hanging", num_envs=B, warmup_steps=0, self_collision=self_collision, device="cuda")
        args = solve_inputs(env, torch.Generator(device="cuda").manual_seed(1))
        events = {}
        out_r = cloth_position_solve_ref(*args, events=events)
        shift = (out_r - args[1]).abs().max().item()
        plain_ms = timed_ms(lambda: cloth_position_solve_ref(*args), 10)[0]
        nbytes, flops = solve_cost(env.solve_spec, B, **events)  # the contacts these inputs make
        bound, bound_by = bound_ms(nbytes, flops)
        outs = {}
        for name, solve in kernels.items():
            outs[name] = solve(*args)
            torch.cuda.synchronize()
            err = (outs[name] - out_r).abs().max().item()
            ms, (eager, host) = graph_ms(lambda: solve(*args)), timed_ms(lambda: solve(*args), 200)
            print(f"[kernel] {name} B={B} self_collision={self_collision}: max|kernel - plain| = {err:.3e} "
                  f"(tol {SOLVE_TOL}; the solve moved x by up to {shift:.3e}); kernel {ms:.5f} ms on the device "
                  f"({eager:.5f} ms per eager call, {host:.5f} ms of it on the host), plain {plain_ms:.4f} ms per "
                  f"call; bound {bound:.5f} ms by {bound_by} ({nbytes} bytes, {flops} f32 operations with "
                  f"{events['contacts']} hook contacts and {events['self_hits']} self-collision hits), "
                  f"{100 * bound / ms:.2f}% of it; on {card}")
            if not err <= SOLVE_TOL:
                fail(f"{name} disagrees with the plain version at B={B}: {err}")
            kernel_stats[(name, B, self_collision)] = (err, ms, plain_ms, bound, bound_by)
        k1_k2 = (outs["cloth_solve_env"] - outs["cloth_solve"]).abs().max().item()
        print(f"[kernel] K1's port vs K2's at B={B} self_collision={self_collision}: max |diff| = {k1_k2:.3e} (tol {SOLVE_TOL})")
        if not k1_k2 <= SOLVE_TOL:
            fail(f"cloth_solve_env disagrees with cloth_solve at B={B}: {k1_k2}")
    print(f"[kernel] phase took {time.perf_counter() - t_phase:.2f} s")

    # ---- 4. the slice at full width ---------------------------------------
    cfg = load_config("cloth_hanging_multi_hepi_trpl")
    trainer = trainer_from_config(cfg, device="cuda")
    B = trainer.env.cfg.num_envs
    print(f"[slice] cloth_hanging HEPi: {B} envs, latent {cfg['algorithm']['latent_dim']}, "
          f"{cfg['algorithm']['num_ori']} orientations, dtype {cfg['algorithm']['dtype']}, "
          f"{trainer.cfg.steps_per_batch} steps per collect")
    LAUNCHES.update(cloth_solve=0, cloth_solve_env=0)
    reset_segment_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = trainer.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, batch, stats = trainer._collect(state)
    torch.cuda.synchronize()
    t_collect = time.perf_counter() - t0
    t0 = time.perf_counter()
    success = trainer.eval_success(state, 100, 0.1)
    torch.cuda.synchronize()
    t_eval = time.perf_counter() - t0
    launches = LAUNCHES["cloth_solve"]
    segment_launches, on_the_spot = segment_counts()

    frames = trainer.cfg.steps_per_batch * B
    tensors = {f"batch.{k}": v for k, v in batch._asdict().items() if k != "tobs"}
    tensors.update({f"batch.tobs.{k}": v for k, v in batch.tobs.items()})
    tensors.update({f"obs.{k}": v for k, v in state.obs.items()})
    tensors.update({f"success.{k}": v for k, v in success.items()})
    tensors["particles"] = state.env_state.scene.particles.pos
    tensors["initial_entropy"] = state.initial_entropy
    for name, t in tensors.items():
        if t.device.type != "cuda":
            fail(f"{name} is on {t.device}, not on the card")
        if t.is_floating_point() and not torch.isfinite(t).all():
            fail(f"{name} holds non-finite values")
    if batch.action.shape != (trainer.cfg.steps_per_batch, B, trainer.env.cfg.action_dim):
        fail(f"batch.action has shape {tuple(batch.action.shape)}")
    expected = 2 * (10 + 100 + 10 + 100)
    print(f"[slice] init {t_init:.3f} s; collect {t_collect:.3f} s = {frames / t_collect:.1f} env-steps/s "
          f"({frames} frames); eval_success {t_eval:.3f} s = {100 * B / t_eval:.1f} env-steps/s; on {card}")
    print(f"[slice] success_rate {success['success_rate'].item():.4f}, mean_final_distance "
          f"{success['mean_final_distance'].item():.4f}, episodes in collect {stats['train/episodes'].item():.0f}; "
          f"cloth_solve launches {launches} (expected {expected})")
    print(f"[slice] segment_sum launches {segment_launches} (HEPi's message sums), CSRs made on the spot {on_the_spot}")
    if launches != expected or LAUNCHES["cloth_solve_env"] != 0:
        fail(f"the rollout path launched {dict(LAUNCHES)}, expected cloth_solve {expected} and cloth_solve_env 0")
    if not segment_launches > 0 or on_the_spot:
        fail(f"the rollout path launched segment_sum {segment_launches} times, made {on_the_spot} CSRs on the spot")

    # ---- 5. the slice on a small input against the CPU --------------------
    parity_phase(card, "cloth_hanging_multi_hepi_trpl", {"particles": lambda s: s.scene.particles.pos})

    # ---- 6. training at full width through the CLI -------------------------
    # K1's port: 2 substeps x (10 warmup steps + one iteration of 100 steps)
    segment_calls = {}  # each HEPi family's largest segment_sum call in its update, for phase 15b
    run_dir, cloth_launches = train_phase(
        card, "cloth_hanging_multi_hepi_trpl", ["env.kwargs.use_pallas_solver=true", "collector.total_frames=10000"],
        {"cloth_solve": 0, "cloth_solve_env": 2 * (10 + 100)}, record=LargestSegmentCall(segment_calls, "cloth"),
    )
    env_launches = cloth_launches["cloth_solve_env"]

    # ---- 7. play on that run -------------------------------------------------
    play_phase(card, run_dir)

    # ---- 8. one update phase on the card against the CPU ---------------------
    update_parity_phase()

    # ---- 9. the rigid_insertion rollout on a small input against the CPU ---
    parity_phase(card, RIGID_CONFIG, {"body positions": lambda s: s.scene.bodies.pos})

    # ---- 10. rigid_insertion training at full width through the CLI -------
    rigid_run, rigid_launches = train_phase(card, RIGID_CONFIG, ["collector.total_frames=100000"],
                                            {"cloth_solve": 0, "cloth_solve_env": 0},
                                            record=LargestSegmentCall(segment_calls, "rigid"))

    # ---- 11. play on that run (kept for phase 33) -------------------------------
    play_phase(card, rigid_run, keep=True)

    # ---- 12. where the rigid collect's device time goes -----------------------
    profile_phase(card, RIGID_CONFIG)

    # ---- 13. the cloth env's XPBD solver mode against the tiled kernel mode ---
    cloth_xpbd_phase(card)

    # ---- 14. the rope rollouts on a small input against the CPU --------------
    rope_positions = {"links": lambda s: s.scene.particles.pos, "grippers": lambda s: s.scene.bodies.pos}
    for rope_config in (ROPE_CONFIG, "rope_shaping_hepi_trpl"):
        parity_phase(card, rope_config, rope_positions)

    # ---- 15. rope_closing training at full width through the CLI ------------
    run_dir, rope_launches = train_phase(card, ROPE_CONFIG, ["collector.total_frames=40000"],
                                         {"cloth_solve": 0, "cloth_solve_env": 0},
                                         record=LargestSegmentCall(segment_calls, "rope"))

    # ---- 15b. the segment-sum kernel on each family's largest update call -----
    segment_stats = segment_kernel_phase(card, segment_calls)
    del segment_calls

    # ---- 16. play on that run -------------------------------------------------
    play_phase(card, run_dir, steps=200)

    # ---- 17. where the rope collect's device time goes -------------------------
    profile_phase(card, ROPE_CONFIG)

    # ---- 18. EMPN on cloth_hanging at full width through the CLI ------------
    # solver mode "auto" launches K2's port: 2 substeps x (10 warm-up steps + 100 control steps);
    # the fresh trainer of the restore check resets after the count is read
    run_dir, empn_launches = train_phase(card, "cloth_hanging_multi_empn_trpl", ["collector.total_frames=10000"],
                                         {"cloth_solve": 2 * (10 + 100), "cloth_solve_env": 0})
    shutil.rmtree(os.path.dirname(run_dir))

    # ---- 19. the Transformer on rigid_insertion at full width ----------------
    # 1 epoch of the update, not the YAML's 5: depth cut for the script's time
    short = ["collector.total_frames=100000", "algorithm.objective.ppo_epochs=1"]
    run_dir, _ = train_phase(card, "rigid_insertion_multi_transformer_trpl", short, {"cloth_solve": 0, "cloth_solve_env": 0})
    shutil.rmtree(os.path.dirname(run_dir))

    # ---- 20. two-gripper HEPi at full width, then play ------------------------
    run_dir, _ = train_phase(card, "rigid_insertion_two_agents_multi_hepi_trpl", short,
                             {"cloth_solve": 0, "cloth_solve_env": 0})
    play_phase(card, run_dir)

    # ---- 21. every other model on a small input against the CPU --------------
    for model in ("empn", "transformer", "gcn", "meshgraphnet", "mlp"):
        parity_phase(card, RIGID_CONFIG, {"body positions": lambda s: s.scene.bodies.pos}, model=model)
    for model in ("empn", "transformer"):
        parity_phase(card, "cloth_hanging_multi_hepi_trpl", {"particles": lambda s: s.scene.particles.pos}, model=model)

    # ---- 22. where the new models' update time goes ---------------------------
    update_profile_phase(card, "cloth_hanging_multi_empn_trpl", collect_steps=20)  # 2000 samples: 10 minibatches of 200
    update_profile_phase(card, "rigid_insertion_multi_transformer_trpl", collect_steps=10)  # 10 minibatches of 1000
    update_profile_phase(card, "rigid_insertion_two_agents_multi_hepi_trpl", collect_steps=10)

    # ---- 23. KL-penalty PPO (beta adapted per iteration) at full width -------
    run_dir, _ = train_phase(card, RIGID_CONFIG, ["collector.total_frames=100000", "algo=kl_ppo",
                                                  "algorithm.objective.kl_beta_interval=iteration"],
                             {"cloth_solve": 0, "cloth_solve_env": 0})
    shutil.rmtree(os.path.dirname(run_dir))

    # ---- 24. clipped PPO on cloth_hanging at full width (K2's port) ---------
    run_dir, ppo_launches = train_phase(card, "cloth_hanging_multi_hepi_trpl", ["collector.total_frames=10000", "algo=ppo"],
                                        {"cloth_solve": 2 * (10 + 100), "cloth_solve_env": 0})
    shutil.rmtree(os.path.dirname(run_dir))

    # ---- 25. PAPI on the cloth Transformer at full width (K2's port) --------
    papi_overrides = ["algorithm.projection.proj_type=papi", "algorithm.policy.contextual_std=false",
                      "algorithm.objective.papi_steps=true"]
    run_dir, papi_launches = train_phase(card, "cloth_hanging_multi_transformer_trpl",
                                         ["collector.total_frames=10000", *papi_overrides],
                                         {"cloth_solve": 2 * (10 + 100), "cloth_solve_env": 0})
    shutil.rmtree(os.path.dirname(run_dir))
    papi_window_phase(card, "cloth_hanging_multi_transformer_trpl", papi_overrides)

    # ---- 26. the new algorithms and projections, card vs CPU ------------------
    for overrides in (["algo=ppo"], ["algo=kl_ppo"], ["algo=kl_ppo", "algorithm.objective.kl_beta_interval=iteration"],
                      ["algorithm.projection.proj_type=frob"], ["algorithm.projection.proj_type=w2"],
                      ["algorithm.projection.proj_type=papi"]):
        update_parity_phase(overrides=tuple(overrides))
    update_parity_phase("cloth_hanging_multi_transformer_trpl", tuple(papi_overrides), papi=True)
    fullcov_parity_phase(card)

    # ---- 27. where the update time of ppo and kl_ppo goes ----------------------
    for algo in ("kl_ppo", "ppo"):
        update_profile_phase(card, RIGID_CONFIG, collect_steps=10, overrides=(f"algo={algo}",))

    new = new_phases(card, rigid_run=rigid_run)

    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} gate(s) failed: {FAILURES}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"geometry_rl_torch/csrc/{name}.cu",
         "replaces": f"geometry_rl_tpu/sim/pallas_cloth.py:{line}", "launches": n_launch,
         "max_abs_err": kernel_stats[(name, 100, False)][0], "ms": kernel_stats[(name, 100, False)][1],
         "plain_ms": kernel_stats[(name, 100, False)][2], "bound_ms": kernel_stats[(name, 100, False)][3],
         "bound_by": kernel_stats[(name, 100, False)][4], "library_ms": None,
         "ms_b1000": kernel_stats[(name, 1000, False)][1], "bound_ms_b1000": kernel_stats[(name, 1000, False)][3],
         "ms_self_b4": kernel_stats[(name, 4, True)][1], "launches_empn_training": empn_launches[name],
         "launches_ppo_training": ppo_launches[name], "launches_papi_training": papi_launches[name],
         **({"launches_bc_recording": new["bc"]["record"], "launches_bc_evals": new["bc"]["eval_rollout"] + new["bc"]["eval_success"],
             "launches_render": new["render"], "launches_dp_rank": new["dp"]["rank"]["cloth_solve"]}
            if name == "cloth_solve" else {}),
         "launches_smoke_env_cloth": new["smoke_env"]["cloth_hanging"][name],
         "launches_learn_check": new["learn_check"][name]}
        for name, line, n_launch in (("cloth_solve", 385, launches), ("cloth_solve_env", 456, env_launches))
    ] + [
        # no Pallas kernel: the JAX package's one-hot contractions of scatter_sum and gather_nodes, left to XLA
        {"name": "segment_sum", "route": "cuda", "source": "geometry_rl_torch/csrc/segment_sum.cu",
         "replaces": "geometry_rl_tpu/models/common.py:76", "launches": segment_launches,
         "max_abs_err": segment_stats["rigid"][0], "ms": segment_stats["rigid"][1], "plain_ms": segment_stats["rigid"][2],
         "bound_ms": segment_stats["rigid"][3], "bound_by": segment_stats["rigid"][4],
         "library_ms": segment_stats["rigid"][5], "library_deterministic_ms": segment_stats["rigid"][6],
         "shape": segment_stats["rigid"][7], "index_add_sequence_ms": segment_stats["rigid"][8],
         **{f"{key}_{family}": segment_stats[family][i] for family in ("cloth", "rope")
            for i, key in ((0, "max_abs_err"), (1, "ms"), (3, "bound_ms"), (5, "library_ms"),
                           (8, "index_add_sequence_ms"))},
         "launches_cloth_training": cloth_launches["segment_sum"], "launches_rigid_training": rigid_launches["segment_sum"],
         "launches_rope_training": rope_launches["segment_sum"]}
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
