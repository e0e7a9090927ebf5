"""Slice sampler (Neal 2003): step-out + shrinkage along directions.

Behavioral parity with the reference SliceSampler
(photon-lib hyperparameter/SliceSampler.scala:63-210): draw along a random
or per-dimension unit direction, step the slice out in units of
``step_size`` until the endpoints fall below the level, then sample
uniformly on the slice, shrinking on rejection.
"""
from __future__ import annotations

import math

import numpy as np


class SliceSampler:
    def __init__(
        self,
        step_size: float = 1.0,
        max_steps_out: int = 1000,
        seed: int = 0,
    ):
        self.step_size = step_size
        self.max_steps_out = max_steps_out
        self._rng = np.random.default_rng(seed)

    # --- public API -------------------------------------------------------

    def draw(self, x: np.ndarray, logp) -> np.ndarray:
        """One sample along a uniformly-random direction through ``x``."""
        direction = self._rng.normal(size=x.shape)
        direction /= np.linalg.norm(direction)
        return self._draw_along(np.asarray(x, dtype=float), logp, direction)

    def draw_dimension_wise(self, x: np.ndarray, logp) -> np.ndarray:
        """One sweep of axis-aligned slice-sampling updates (reference
        SliceSampler.drawDimensionWise)."""
        cur = np.asarray(x, dtype=float).copy()
        for i in range(cur.shape[0]):
            e = np.zeros_like(cur)
            e[i] = 1.0
            cur = self._draw_along(cur, logp, e)
        return cur

    # --- internals --------------------------------------------------------

    def _draw_along(self, x, logp, direction) -> np.ndarray:
        y = math.log(self._rng.uniform()) + logp(x)
        lower, upper = self._step_out(x, y, logp, direction)
        while True:
            t = self._rng.uniform(lower, upper)
            new_x = x + t * direction
            if logp(new_x) > y:
                return new_x
            # shrink toward 0 (the current point)
            if t < 0:
                lower = t
            else:
                upper = t
            if upper - lower < 1e-15:
                return x

    def _step_out(self, x, y, logp, direction):
        """Expand [lower, upper] (scalars along ``direction``) past the
        level set (SliceSampler.scala:stepOut)."""
        lower = -self.step_size * self._rng.uniform()
        upper = lower + self.step_size
        steps = 0
        while logp(x + lower * direction) > y and steps < self.max_steps_out:
            lower -= self.step_size
            steps += 1
        steps = 0
        while logp(x + upper * direction) > y and steps < self.max_steps_out:
            upper += self.step_size
            steps += 1
        return lower, upper
