"""Per-coordinate loss, gradient norm and finiteness of a descent sweep.

Counterpart of photon_tpu/obs/health.py. A NaN that enters a
coordinate's state mid-fit would otherwise poison every later sweep, the
checkpoint and the exported model without a word. Each sweep step's
existing outputs give three 0-d tensors on the coordinate's device
(:func:`sweep_health`); descent stacks every coordinate's triple and
reads them in the ONE host copy that already closes the sweep, then
applies the divergence policy at the sweep boundary:

- ``"raise"`` (default): :class:`DivergenceError` at the first sweep
  whose health is not finite;
- ``"warn"``: log it and keep training;
- ``"halt_coordinate"``: re-initialize and freeze the offending
  coordinate, keep training the others.

``GameEstimator(on_divergence=...)`` picks the policy; None reads
``PHOTON_ON_DIVERGENCE``, then ``"raise"``.
"""
from __future__ import annotations

import os

import torch

__all__ = [
    "DIVERGENCE_POLICIES",
    "DivergenceError",
    "resolve_policy",
    "sweep_health",
]

DIVERGENCE_POLICIES = ("raise", "warn", "halt_coordinate")


class DivergenceError(RuntimeError):
    """A coordinate's sweep produced a non-finite loss, gradient or state.

    Carries the coordinate, the sweep and the host health row, so a
    driver can report where the fit went bad."""

    def __init__(self, coordinate: str, iteration: int, health: dict):
        self.coordinate = coordinate
        self.iteration = iteration
        self.health = dict(health)
        super().__init__(
            f"coordinate {coordinate!r} diverged at sweep {iteration}: "
            f"loss={health.get('loss')!r} gnorm={health.get('gnorm')!r} "
            f"finite={health.get('finite')!r}"
        )


def resolve_policy(policy: str | None) -> str:
    """The divergence policy: the argument, else ``PHOTON_ON_DIVERGENCE``,
    else ``"raise"``."""
    if policy is None:
        policy = os.environ.get("PHOTON_ON_DIVERGENCE", "").strip() or "raise"
    if policy not in DIVERGENCE_POLICIES:
        raise ValueError(
            f"on_divergence must be one of {DIVERGENCE_POLICIES}, got {policy!r}"
        )
    return policy


def _leaves(state):
    if isinstance(state, torch.Tensor):
        yield state
    else:
        for s in state:
            yield from _leaves(s)


def sweep_health(state, info) -> dict:
    """The health triple of one sweep step as 0-d tensors on its device:

    - ``loss``: Σ of the optimizer's final objective values (summed over
      the entity lanes of every RE bucket);
    - ``gnorm``: the L2 norm over every final gradient, taken in float32
      as the JAX package takes it;
    - ``finite``: loss, gnorm and every float leaf of the new state are
      finite.

    ``info`` is one OptimizeResult or a list of them (one per RE
    bucket); ``state`` is the coordinate's new state."""
    # a list is the RE case; an OptimizeResult is a NamedTuple (a tuple)
    infos = info if isinstance(info, list) else [info]
    loss = sum(r.value.sum() for r in infos)
    gsq = sum(r.gradient.to(torch.float32).square().sum() for r in infos)
    gnorm = gsq.sqrt()
    finite = torch.isfinite(loss) & torch.isfinite(gnorm)
    for leaf in _leaves(state):
        if leaf.is_floating_point():
            finite = finite & torch.isfinite(leaf).all()
    return {
        "loss": loss.to(torch.float32),
        "gnorm": gnorm.to(torch.float32),
        "finite": finite,
    }
