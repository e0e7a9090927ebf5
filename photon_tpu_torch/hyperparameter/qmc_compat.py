"""scipy version compatibility for quasi-Monte-Carlo engines.

scipy renamed the ``qmc.Sobol`` seeding kwarg: ``seed=`` through 1.14,
``rng=`` from 1.15 (SPEC 7). Passing the wrong spelling raises a
``TypeError`` at construction. Dispatch on the constructor
signature once, at import time, so every Sobol call site in the package
spells seeding the same way on either scipy.
"""
from __future__ import annotations

import inspect


def _sobol_seed_kwarg() -> str:
    from scipy.stats import qmc

    params = inspect.signature(qmc.Sobol.__init__).parameters
    return "rng" if "rng" in params else "seed"


_SEED_KWARG: str | None = None


def sobol_engine(d: int, *, scramble: bool = True, seed=None):
    """``qmc.Sobol(d=..., scramble=..., <seed-kwarg>=seed)`` spelled for
    the installed scipy."""
    global _SEED_KWARG
    from scipy.stats import qmc

    if _SEED_KWARG is None:
        _SEED_KWARG = _sobol_seed_kwarg()
    return qmc.Sobol(d=d, scramble=scramble, **{_SEED_KWARG: seed})
