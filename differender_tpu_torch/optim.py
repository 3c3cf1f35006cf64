"""Optimizers and gradient hygiene (counterpart of
``differender_tpu/optim.py``).

* :func:`tf_momentum` -- the reference's TF optimizer: momentum with
  value-clipped gradients and an exponentially decaying rate,
  ``mom <- gamma*mom + lr_k*clamp(g, -max_grad, max_grad)``,
  ``p <- p - mom``, ``lr_k = lr * lr_decay**k``.  Follow it with
  :func:`project_nonneg` for the reference's ``max(tf - mom, 0)``.
* :func:`adamw_onecycle` -- AdamW under a cosine OneCycle schedule, the
  volume-fitting optimizer.
* :func:`project_nonneg`, :func:`project_unit` -- in-place projections.
* :func:`nan_to_num_grads` -- the reference's NaN/Inf scrub, and
  :func:`value_and_clean_grad`, a function's value and its scrubbed
  gradients.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch


class TFMomentum(torch.optim.Optimizer):
    """See the module docstring; one state per parameter: ``momentum`` and
    the step count ``step``."""

    def __init__(self, params, lr: float = 0.1, gamma: float = 0.9,
                 max_grad: float = 0.1, lr_decay: float = 0.99):
        super().__init__(params, dict(lr=lr, gamma=gamma, max_grad=max_grad,
                                      lr_decay=lr_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["momentum"] = torch.zeros_like(p)
                    state["step"] = 0
                # The rate in f32, as the JAX transform computes it.
                cur_lr = float(np.float32(group["lr"]) * np.power(
                    np.float32(group["lr_decay"]),
                    np.float32(state["step"])))
                mom = state["momentum"]
                mom.mul_(group["gamma"]).add_(
                    torch.clamp(p.grad, -group["max_grad"],
                                group["max_grad"]), alpha=cur_lr)
                p.sub_(mom)
                state["step"] += 1
        return loss


# The JAX package's name for it.
tf_momentum = TFMomentum


def adamw_onecycle(params, max_lr: float, total_steps: int,
                   weight_decay: float = 0.0):
    """``(torch.optim.AdamW, OneCycleLR)``: the rate starts at
    ``max_lr / 25``, rises over 30% of ``total_steps`` to ``max_lr`` and
    anneals by a cosine; momentum is not cycled (optax's AdamW keeps
    ``b1 = 0.9``).  Call ``opt.step()`` then ``sched.step()`` per step."""
    if int(0.3 * total_steps) < 1:
        raise ValueError(
            f"total_steps={total_steps} too small for a OneCycle schedule "
            "(needs >= 4 so the warmup phase is at least one step)")
    opt = torch.optim.AdamW(params, lr=max_lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    sched = torch.optim.lr_scheduler.OneCycleLR(
        opt, max_lr=max_lr, total_steps=total_steps, pct_start=0.3,
        anneal_strategy="cos", cycle_momentum=False, div_factor=25.0,
        final_div_factor=1e4)
    return opt, sched


def _tensors(params):
    if isinstance(params, torch.Tensor):
        return [params]
    return list(params)


@torch.no_grad()
def project_nonneg(params) -> None:
    """``max(., 0)`` in place on a tensor or an iterable of tensors."""
    for p in _tensors(params):
        p.clamp_(min=0.0)


@torch.no_grad()
def project_unit(params) -> None:
    """Clamp to [0, 1] in place: the volume-fitting loop's post-step
    projection."""
    for p in _tensors(params):
        p.clamp_(0.0, 1.0)


def nan_to_num_grads(grads):
    """``torch.nan_to_num`` of a tensor, or of each tensor of a list, tuple
    or dict (same structure back)."""
    if isinstance(grads, torch.Tensor):
        return torch.nan_to_num(grads)
    if isinstance(grads, dict):
        return {k: nan_to_num_grads(v) for k, v in grads.items()}
    return type(grads)(nan_to_num_grads(g) for g in grads)


def value_and_clean_grad(fn: Callable, argnums=0, has_aux: bool = False):
    """``fn``'s value and its gradients with respect to the positional
    arguments ``argnums`` (an int or a tuple, as in
    ``jax.value_and_grad``), scrubbed by :func:`nan_to_num_grads`.  ``fn``
    returns a scalar tensor, or ``(scalar, aux)`` with ``has_aux``; the
    wrapped function returns ``(value, grads)`` or ``((value, aux),
    grads)``, all detached.  Arguments are differentiated as given: pass
    float tensors; they need not require grad."""
    single = isinstance(argnums, int)
    nums = (argnums,) if single else tuple(argnums)

    def wrapped(*args, **kwargs):
        args = list(args)
        for i in nums:
            args[i] = torch.as_tensor(args[i]).detach().requires_grad_(True)
        with torch.enable_grad():
            out = fn(*args, **kwargs)
            value, aux = out if has_aux else (out, None)
            grads = torch.autograd.grad(value, [args[i] for i in nums],
                                        allow_unused=True)
        grads = nan_to_num_grads(tuple(
            torch.zeros_like(args[i]) if g is None else g
            for i, g in zip(nums, grads)))
        grads = grads[0] if single else grads
        value = value.detach()
        return ((value, aux) if has_aux else value), grads

    return wrapped


__all__ = ["TFMomentum", "tf_momentum", "adamw_onecycle", "project_nonneg",
           "project_unit", "nan_to_num_grads", "value_and_clean_grad"]
