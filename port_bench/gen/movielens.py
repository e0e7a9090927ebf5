"""MovieLens-shaped GLMix data from a seed: ratings as rows, users and movies
as entities, a movie's genres as features.

Each user rates at least ``min_user_rows`` movies and each movie is rated
at least once, as in MovieLens 20M; the other rows go to users and movies
in proportion to log-normal popularity weights. A movie has 1 to
``max_genres`` distinct genres. The label of a row (the rating is high, 1,
or not, 0) comes from a logistic model of a user bias, a movie bias and the
user's affinity to each of the movie's genres.

The fixed effect's shard is sparse: the intercept (column 0), the user's
one-hot column, the movie's and its genres', value 1 each. The per-user
random effect's features are an intercept and the movie's genres (a
user's taste over genres); the per-movie random effect's are an intercept
alone (a movie's bias), since the data set states no user features.
"""
from __future__ import annotations

import numpy as np


def _ids(rng: np.random.Generator, rows: int, entities: int, floor: int, sigma: float):
    """Entity ids of ``rows`` rows: ``floor`` rows for each entity, the rest
    drawn in proportion to log-normal weights, in a random order."""
    if rows < floor * entities:
        raise ValueError("fewer rows than the entities' floor")
    weights = rng.lognormal(0.0, sigma, size=entities)
    rest = rng.choice(entities, size=rows - floor * entities, p=weights / weights.sum())
    return rng.permutation(np.concatenate([np.repeat(np.arange(entities), floor), rest]))


def movielens_arrays(seed: int, rows: int, users: int, movies: int, genres: int,
                     max_genres: int, min_user_rows: int, user_sigma: float,
                     movie_sigma: float) -> dict:
    """The cell's inputs as host arrays: ``indptr``/``indices``/``values``
    (the fixed effect's CSR over ``fe_dim`` = 1 + users + movies + genres
    columns, values float64), ``labels`` (0/1 float64), and per random
    effect (``user``, and ``item`` for the movie) ``{"ids", "tags", "features"}``: int64
    entity ids, their string tags and the [rows, d] float32 features."""
    rng = np.random.default_rng(seed)
    user = _ids(rng, rows, users, min_user_rows, user_sigma)
    movie = _ids(rng, rows, movies, 1, movie_sigma)
    # each movie's genres: a count in 1..max_genres, then that many distinct genres
    count = rng.integers(1, max_genres + 1, size=movies)
    ranked = np.argsort(rng.random((movies, genres)), axis=1)[:, :max_genres]
    has = np.zeros((movies, genres), dtype=bool)
    np.put_along_axis(has, ranked, np.arange(max_genres) < count[:, None], axis=1)
    row_genres = has[movie]

    affinity = rng.normal(0.0, 0.5, size=(users, genres))
    margin = (rng.normal(0.0, 0.5, size=users)[user] + rng.normal(0.0, 0.8, size=movies)[movie]
              + (affinity[user] * row_genres).sum(axis=1))
    labels = (rng.uniform(size=rows) < 1.0 / (1.0 + np.exp(-margin))).astype(np.float64)

    per_row = 3 + count[movie]
    indptr = np.zeros(rows + 1, dtype=np.int64)
    np.cumsum(per_row, out=indptr[1:])
    first = indptr[:-1]
    indices = np.empty(indptr[-1], dtype=np.int32)
    indices[first] = 0
    indices[first + 1] = 1 + user
    indices[first + 2] = 1 + users + movie
    g_row, g_col = np.nonzero(row_genres)  # row-major: each row's genres in order
    slot = np.arange(len(g_row)) - np.repeat(np.cumsum(count[movie]) - count[movie],
                                             count[movie])
    indices[first[g_row] + 3 + slot] = 1 + users + movies + g_col
    user_features = np.concatenate(
        [np.ones((rows, 1), np.float32), row_genres.astype(np.float32)], axis=1)
    out = {"indptr": indptr, "indices": indices, "values": np.ones(indptr[-1]),
           "labels": labels, "fe_dim": 1 + users + movies + genres, "random_effects": {}}
    for name, ids, feats in (("user", user, user_features),
                             ("item", movie, np.ones((rows, 1), np.float32))):
        out["random_effects"][name] = {"ids": ids, "tags": np.char.add(name[:1], ids.astype(str)),
                                       "features": feats}
    return out
