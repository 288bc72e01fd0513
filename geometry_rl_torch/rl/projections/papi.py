"""PAPI projection (port of `geometry_rl_tpu/rl/projections/papi.py`).

PAPI enforces ONE joint bound eps = mean_bound + cov_bound on the EXPECTED
KL over the batch (not per sample): it interpolates the covariance toward
the old one, then scales the mean update by a factor solving the remaining
budget. Diagonal covariances throughout.

`papi_steps` is the post-update backtracking: after the update's epochs,
back up to the most recent parameters (the current ones, then a ring of
earlier ones) whose expected KL to the behaviour policy is inside the
budget, then run `n_iters` PAPI iterations that contract the mean head's
weights toward that feasible head and overwrite the non-contextual std with
the projected one. The parameters live in the policy module; this module
works on `{name: tensor}` dicts of them (`named_parameters()`), and the
caller evaluates the policy at such a dict with `torch.func.functional_call`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Tuple

import torch

from ...parallel.mesh import batch_global_mean
from ..gaussian import DiagGaussian, entropy, kl_parts
from .base import BaseProjection, entropy_inequality_projection

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class PAPIProjection(BaseProjection):
    """The distribution-level PAPI projection; `get_projection_layer("papi")`
    sets entropy_first."""

    def _trust_region_projection(self, p: DiagGaussian, q: DiagGaussian, eps, eps_cov) -> DiagGaussian:
        eps_joint = eps + eps_cov
        maha_part, cov_part = kl_parts(p, q)
        maha_mean, cov_mean = batch_global_mean(maha_part), batch_global_mean(cov_part)
        exceeded = maha_mean + cov_mean > eps_joint + 1e-6

        # covariance rotation / rescaling at the level of the expectation
        var, old_var = p.std**2, q.std**2
        eta_rot = eps_joint / torch.clamp(maha_mean + cov_mean, min=1e-16)
        new_var = torch.where(exceeded, (1.0 - eta_rot) * old_var + eta_rot * var, var)
        cov_new = torch.where(exceeded, _expected_cov_part(new_var, old_var), cov_mean)

        # mean interpolation
        still_exceeded = maha_mean + cov_new > eps_joint + 1e-6
        eta_mean = torch.sqrt(torch.clamp(eps_joint - cov_new, min=1e-16) / torch.clamp(maha_mean, min=1e-16))
        eta_mean = torch.where(still_exceeded, torch.clamp(eta_mean, max=1.0), 1.0)
        return DiagGaussian(q.mean + eta_mean * (p.mean - q.mean), torch.sqrt(new_var))


def _expected_cov_part(new_var: torch.Tensor, old_var: torch.Tensor) -> torch.Tensor:
    """The batch mean of KL's cov part for variances new_var against old_var."""
    k = new_var.shape[-1]
    trace_term = 0.5 * batch_global_mean((new_var / old_var).sum(-1) - k)
    entropy_diff = 0.5 * batch_global_mean(torch.log(old_var).sum(-1) - torch.log(new_var).sum(-1))
    return trace_term + entropy_diff


def papi_weight_update(params: Params, intermed_params: Params, eta) -> Params:
    """Interpolate every parameter toward the intermediate (pre-update) one by
    eta; pass dicts holding only the last layer's entries for the last-layer
    variant."""
    return {k: intermed_params[k] + eta * (v - intermed_params[k]) for k, v in params.items()}


class PAPIState(NamedTuple):
    """The cross-iteration carry: a ring of H parameter snapshots, most recent
    first, stacked per parameter; how many of them are valid; the
    multiplicative LR scale. `hist_len` and `lr_scale` are 0-d CPU tensors,
    so reading them costs no device synchronisation."""

    history: Params  # name -> [H, ...], on the policy's device
    hist_len: torch.Tensor  # int32, CPU
    lr_scale: torch.Tensor  # float32, CPU


def papi_init_state(params: Params, history: int = 8) -> PAPIState:
    """The ring filled with copies of the initial params (masked out by
    hist_len until real entries are pushed)."""
    stacked = {k: v.detach()[None].expand((history,) + v.shape).clone() for k, v in params.items()}
    return PAPIState(history=stacked, hist_len=torch.zeros((), dtype=torch.int32),
                     lr_scale=torch.ones((), dtype=torch.float32))


def find_papi_paths(params: Params) -> Tuple[str, str, str]:
    """(mean weight, mean bias, pre_std) names in a policy's parameters. PAPI
    needs a Dense mean head named `mean` and a NON-contextual std: a 1-D
    `pre_std` parameter. HEPi and EMPN (no `mean` head, the equivariant
    output is the mean) and any contextual std are refused."""
    kernel = bias = pre_std = None
    for name, value in params.items():
        keys = tuple(name.split("."))
        if keys[-2:] == ("mean", "weight"):
            kernel = name
        elif keys[-2:] == ("mean", "bias"):
            bias = name
        elif keys[-1] == "pre_std" or (len(keys) >= 2 and keys[-2] == "pre_std"):
            if keys[-1] != "pre_std" or value.ndim != 1:
                raise ValueError(
                    "PAPI steps require a non-contextual std (pre_std must be a "
                    "1-D parameter; got a contextual std head). Build the policy "
                    "with contextual_std=False."
                )
            pre_std = name
    if kernel is None or bias is None or pre_std is None:
        raise ValueError(
            "PAPI steps need a Dense mean head named 'mean' and a 'pre_std' "
            f"parameter; found kernel={kernel}, bias={bias}, pre_std={pre_std}."
        )
    return kernel, bias, pre_std


def papi_project_with_intermed(p: DiagGaussian, q: DiagGaussian, intermed_mean: torch.Tensor, eps_joint,
                               entropy_bound) -> Tuple[torch.Tensor, torch.Tensor]:
    """One PAPI step with an intermediate mean: the entropy-first inequality
    projection, the covariance rotation toward the old covariance, then the
    quadratic line search for eta pulling the mean toward `intermed_mean`.
    Returns (eta_mean, the projected std row [A])."""
    p = entropy_inequality_projection(p, entropy_bound)
    var, old_var = p.std**2, q.std**2

    maha_part, cov_part = kl_parts(p, q)
    maha_part, cov_part = batch_global_mean(maha_part), batch_global_mean(cov_part)
    prec = 1.0 / old_var
    maha_inter = 0.5 * batch_global_mean(((intermed_mean - q.mean) ** 2 * prec).sum(-1))
    mm = torch.minimum(maha_part, maha_inter)

    exceeded = maha_part + cov_part > eps_joint + 1e-6
    eta_rot = (eps_joint - mm) / torch.clamp(maha_part + cov_part, min=1e-16)
    new_var = torch.where(exceeded, (1.0 - eta_rot) * old_var + eta_rot * var, var)
    cov_new = torch.where(exceeded, _expected_cov_part(new_var, old_var), cov_part)

    still = maha_part + cov_new > eps_joint + 1e-6
    a = 0.5 * batch_global_mean(((p.mean - intermed_mean) ** 2 * prec).sum(-1))
    b = 0.5 * batch_global_mean(((p.mean - intermed_mean) * (intermed_mean - q.mean) * prec).sum(-1))
    c = maha_inter - torch.clamp(eps_joint - cov_new, min=0.0)
    eta_q = (-b + torch.sqrt(torch.clamp(b * b - a * c, min=1e-16))) / torch.clamp(a, min=1e-16)
    # never extrapolate past the feasible head
    eta_mean = torch.where(still, torch.clamp(eta_q, 0.0, 1.0), 1.0)
    # non-contextual: every row of the projected std is the same; row 0
    return eta_mean, torch.sqrt(new_var.reshape(-1, new_var.shape[-1])[0])


@torch.no_grad()
def papi_steps(
    apply_fn: Callable[[Params], DiagGaussian],
    params: Params,
    papi: PAPIState,
    q: DiagGaussian,
    mean_bound: float,
    cov_bound: float,
    initial_entropy: torch.Tensor,
    *,
    init_std: float = 1.0,
    minimal_std: float = 1e-5,
    n_iters: int = 20,
    anneal_after: int = 4,
) -> Tuple[Params, PAPIState, bool, int]:
    """Post-update PAPI backtracking and projection.

    apply_fn(params) -> DiagGaussian over the collected observations. Returns
    (new params, new PAPI state with lr_scale unchanged, whether to anneal
    the LR, n_backtracks: the index of the feasible candidate, or
    hist_len + 1 when none is). The caller applies its LR annealing.

    The feasibility scan stops at the first feasible candidate, as the
    reference's early-exiting loop does: it reads one flag back from the
    device per candidate evaluated, the only host synchronisation of the
    step. When no candidate is feasible the iterations are skipped, since
    their result would be discarded. Where `pre_std` is shared over several
    actuators (a multi-gripper policy with share_action_dim) the projected
    std row holds one equal block per actuator and `pre_std` takes one block;
    the reference's loop requires `pre_std` to span the whole action row.
    """
    eps_joint = mean_bound + cov_bound
    k_name, b_name, s_name = find_papi_paths(params)
    hist_size = next(iter(papi.history.values())).shape[0]
    hist_len = int(papi.hist_len)  # a CPU tensor: no device synchronisation

    def candidate(i: int) -> Params:
        # the current params first, then the ring, most recent first
        return params if i == 0 else {k: h[i - 1] for k, h in papi.history.items()}

    idx, found = 0, False
    while idx <= hist_len:
        m, c = kl_parts(apply_fn(candidate(idx)), q)
        if bool(batch_global_mean(m) + batch_global_mean(c) <= eps_joint):  # the one host read per candidate
            found = True
            break
        idx += 1
    anneal_lr = idx >= anneal_after or not found
    if not found:
        # keep the (poor) current policy and do not push it to the history
        return params, papi, anneal_lr, idx

    intermed = candidate(idx)
    intermed_mean = apply_fn(intermed).mean
    a_kernel, a_bias = intermed[k_name], intermed[b_name]
    # start: the current mean head on the intermediate trunk
    working = {**intermed, k_name: params[k_name], b_name: params[b_name]}

    # entropy gate
    ent = batch_global_mean(entropy(q))
    entropy_bound = torch.where(ent / initial_entropy > 0.5, -torch.inf, ent - eps_joint)
    # softplus^-1(init_std - minimal_std), rounded in f32 as the reference does
    shift = torch.log(torch.expm1(torch.tensor(init_std - minimal_std, dtype=torch.float32))).item()

    for _ in range(n_iters):
        eta, std_row = papi_project_with_intermed(apply_fn(working), q, intermed_mean, eps_joint, entropy_bound)
        pre = torch.log(torch.expm1(torch.clamp(std_row - minimal_std, min=1e-8))) - shift
        # a pre_std shared over the actuators (share_action_dim) gives every
        # actuator's block of the row the same values: keep one block
        pre = pre.reshape(-1, working[s_name].numel())[0]
        working = {
            **working,
            k_name: eta * working[k_name] + (1.0 - eta) * a_kernel,
            b_name: eta * working[b_name] + (1.0 - eta) * a_bias,
            s_name: pre.to(working[s_name].dtype),
        }

    history = {k: torch.cat([params[k][None], h[:-1]]) for k, h in papi.history.items()}
    hist_len = torch.clamp(papi.hist_len + 1, max=hist_size).to(torch.int32)
    return working, PAPIState(history=history, hist_len=hist_len, lr_scale=papi.lr_scale), anneal_lr, idx
