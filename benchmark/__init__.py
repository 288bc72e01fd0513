"""The benchmark of `geometry_rl_torch` on one CUDA card.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name from `BENCHMARK.json` at the checkout's root and
the files under this folder: a configuration is `configs/<name>.json`, a
traffic mix `mixes/<name>.json` (its `loop` names a module `loops/<loop>.py`), a
cell `workloads/<name>.json`, a per-layer metric `metrics/<name>.py`. The
plain reference that decides `correct` is `reference/`, a frozen copy of the
port's plain code; the work counts behind the rooflines and the MFU are
`counts/`. Nothing here imports JAX or the JAX package.
"""
