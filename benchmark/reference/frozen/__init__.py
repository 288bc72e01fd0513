"""A frozen copy of the port's plain code, as the benchmark's reference.

These modules are `geometry_rl_torch`'s envs, simulator, graph builders,
HEPi and DeepSets models, TRPL loss with the KL projection and trainer, as
they stood when the benchmark was written, pruned to the cells' path (one
process, HEPi and DeepSets, TRPL) and with the three CUDA kernels replaced
by their plain versions (`models/segment.py`, `sim/cloth_solve.py`). They
import nothing of the port, so a later change to the port is judged against
this copy.
"""
