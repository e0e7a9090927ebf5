"""The generator: deterministic per seed, and the shape the configuration
states."""
from __future__ import annotations

import numpy as np

from port_bench.gen.movielens import movielens_arrays
from port_bench.tests.conftest import SMALL_GAME

SHAPE = {k: v for k, v in SMALL_GAME.items() if k != "generator"}


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _same(a[k], b[k])
        else:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


def test_arrays_repeat_per_seed_and_differ_across_seeds():
    a = movielens_arrays(2**31 + 11, **SHAPE)
    _same(a, movielens_arrays(2**31 + 11, **SHAPE))
    b = movielens_arrays(7, **SHAPE)
    assert not np.array_equal(a["random_effects"]["user"]["ids"], b["random_effects"]["user"]["ids"])
    assert not np.array_equal(a["labels"], b["labels"])


def test_arrays_have_the_configured_shape():
    s = SHAPE
    a = movielens_arrays(3, **s)
    rows, users, movies, genres = s["rows"], s["users"], s["movies"], s["genres"]
    user = a["random_effects"]["user"]["ids"]
    movie = a["random_effects"]["item"]["ids"]
    assert np.bincount(user, minlength=users).min() >= s["min_user_rows"]
    assert np.bincount(movie, minlength=movies).min() >= 1
    assert a["fe_dim"] == 1 + users + movies + genres
    assert set(np.unique(a["labels"]).tolist()) == {0.0, 1.0}
    assert np.all(a["values"] == 1.0)
    per_row = np.diff(a["indptr"])
    assert per_row.min() >= 4 and per_row.max() <= 3 + s["max_genres"]
    feats = a["random_effects"]["user"]["features"]
    assert feats.shape == (rows, 1 + genres) and np.all(feats[:, 0] == 1.0)
    assert np.all(a["random_effects"]["item"]["features"] == 1.0)
    for r in (0, 1, rows // 2, rows - 1):
        cols = a["indices"][a["indptr"][r]:a["indptr"][r + 1]]
        assert cols[0] == 0 and cols[1] == 1 + user[r] and cols[2] == 1 + users + movie[r]
        # the genre columns are the movie's, the same as the per-user features'
        want = 1 + users + movies + np.flatnonzero(feats[r, 1:])
        assert np.array_equal(np.sort(cols[3:]), want)
    # a movie has the same genres on every row
    first = {}
    for r in range(rows):
        g = tuple(np.flatnonzero(feats[r, 1:]))
        assert first.setdefault(movie[r], g) == g
    tags = a["random_effects"]["user"]["tags"]
    assert tags[0] == f"u{user[0]}"
