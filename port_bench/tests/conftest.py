"""A small configuration of the cell, for runs on the CPU."""
from __future__ import annotations

import copy

import pytest

from port_bench import spec

SMALL_GAME = {"generator": "movielens", "rows": 4096, "users": 64, "movies": 24, "genres": 19,
              "max_genres": 3, "min_user_rows": 20, "user_sigma": 1.0, "movie_sigma": 1.5}
_config = spec.config


def small_config(name: str) -> dict:
    cfg = copy.deepcopy(_config(spec.benchmark(), name))
    cfg["data"] = dict(SMALL_GAME)
    cfg["fit"]["random_effects"][0]["active_upper_bound"] = 32
    cfg["fit"]["random_effects"][1]["active_upper_bound"] = 128
    return cfg


@pytest.fixture
def small_cells(monkeypatch):
    """``spec.config`` answering with the small configurations."""
    monkeypatch.setattr(spec, "config", lambda bench, name: small_config(name))
