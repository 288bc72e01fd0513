"""The system's evaluation and check tools (ports of `scripts/smoke_env.py`,
`scripts/eval_breakdown.py` and `scripts/learn_check.py`), each run as
`python -m geometry_rl_torch.tools.<tool>`; `learning_gates` holds a short
training run through the CLI against the JAX package's recorded runs."""
