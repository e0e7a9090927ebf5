"""The single-GLM path at KDD Cup 2010's shape, small, on the CPU.

The port's ``train_glm_grid`` (elastic-net OWL-QN over a sparse batch
with the column-window layout forced, so the plain windowed Xᵀr runs on
every gradient) against the benchmark's plain reference
(``port_bench/reference/owlqn.py``) at float64 on seeded random sparse
data of the cell's shape: 36 or 37 Zipf-popular columns a row. The
benchmark's generator (``port_bench/gen/kdd2010.py``) repeats per seed and
gives the configuration's shape, and the port's window and OWL-QN
counters count what they name.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from photon_tpu_torch import obs
from photon_tpu_torch.data.dataset import DataSet, choose_sparse, to_device_sparse_batch
from photon_tpu_torch.model_training import train_glm_grid
from photon_tpu_torch.ops import sparse_windows as tsw
from photon_tpu_torch.optimize.common import OptimizerConfig
from photon_tpu_torch.optimize.problem import (
    GLMProblemConfig,
    RegularizationContext,
    RegularizationType,
)
from photon_tpu_torch.types import OptimizerType, TaskType
from port_bench.gen.kdd2010 import kdd2010_arrays
from port_bench.reference import owlqn as ref_owlqn

CONFIG = json.loads((Path(__file__).resolve().parents[1] / "port_bench" / "configs"
                     / "glm_kdd2010a.json").read_text())
SMALL = dict(CONFIG["data"], rows=2000, columns=5000)
SMALL.pop("generator")
DATA_SEED = SMALL.pop("seed")
LAMBDA = 2.0  # leaves a quarter of the 5,000 columns nonzero after 10 iterations


def _arrays(permutation_seed=None):
    return kdd2010_arrays(DATA_SEED, permutation_seed=permutation_seed, device="cpu", **SMALL)


def _data(a) -> DataSet:
    n = len(a["labels"])
    return DataSet(indptr=a["indptr"], indices=a["indices"], values=a["values"],
                   labels=a["labels"], offsets=np.zeros(n), weights=np.ones(n),
                   num_features=a["columns"])


def _config(iterations: int) -> GLMProblemConfig:
    return GLMProblemConfig(
        task=TaskType.LOGISTIC_REGRESSION, optimizer=OptimizerType.OWLQN,
        optimizer_config=OptimizerConfig(max_iterations=iterations,
                                         tolerance=CONFIG["fit"]["tolerance"]),
        regularization=RegularizationContext(RegularizationType.ELASTIC_NET, 0.5),
    )


def _spec(iterations: int) -> dict:
    return dict(CONFIG["fit"], **{"lambda": LAMBDA, "max_iterations": iterations})


@pytest.fixture(scope="module")
def fits():
    """The port and the reference, 10 iterations each from a cold start."""
    a = _arrays(permutation_seed=2**31 + 3)
    batch = to_device_sparse_batch(_data(a), dtype=torch.float64, device="cpu",
                                   column_windows=True)
    assert batch.windows is not None
    (port,) = train_glm_grid(batch, _config(10), [LAMBDA], warm_start=False,
                             num_features=a["columns"], device="cpu")
    ref = ref_owlqn.fit(a, _spec(10), device="cpu")
    return port, ref


def test_the_port_follows_the_reference_along_the_first_iterations(fits):
    """Both run the same algorithm in float64 from x = 0; they differ only
    in the order of their sums (the windowed Xᵀr against a flat
    scatter-add), a few units of float64's 2.2e-16 on each value, which
    four iterations do not amplify past 1e-12."""
    port, ref = fits
    path = port.result.loss_history.numpy()
    gaps = np.abs(path[1:5] - ref["path"][1:5]) / np.abs(ref["path"][1:5])
    assert gaps.max() <= 1e-12, gaps
    assert int(port.result.iterations) == ref["iterations"] == 10


def test_the_port_follows_the_reference_to_ten_iterations(fits):
    """After 10 iterations the coefficients agree to 1e-9 relative: the
    iterates are the same up to rounding (the rounding grows with each
    curvature pair: 1e-15 here), the support is the same, and an
    iteration that went another way (another trial accepted, another pair
    dropped) would differ by the step itself, at least 1e-3."""
    port, ref = fits
    x = port.model.coefficients.means.numpy()
    assert np.linalg.norm(x - ref["x"]) <= 1e-9 * np.linalg.norm(ref["x"])
    assert np.array_equal(x != 0, ref["x"] != 0)
    assert abs(float(port.result.value) - ref["value"]) <= 1e-12 * abs(ref["value"])


def test_the_configuration_takes_the_sparse_layout():
    """``train_glm_grid`` places the cell's data set as sparse ELL."""
    p = CONFIG["published"]
    assert choose_sparse(p["rows"], p["columns"], p["nonzeros"], 4)
    assert CONFIG["data"]["columns"] == p["columns"]
    assert CONFIG["data"]["nonzeros_per_row"] == pytest.approx(p["nonzeros"] / p["rows"],
                                                               rel=1e-15)


def test_the_generator_repeats_per_seed_and_gives_the_shape():
    a, b = _arrays(permutation_seed=7), _arrays(permutation_seed=7)
    for k in ("indptr", "indices", "values", "labels"):
        assert np.array_equal(a[k], b[k]), k
    per_row = np.diff(a["indptr"])
    rows = SMALL["rows"]
    # 36 or 37 columns a row, as many 37s as the published mean asks for
    assert set(np.unique(per_row)) == {36, 37}
    assert per_row.sum() == 36 * rows + round((SMALL["nonzeros_per_row"] - 36) * rows)
    assert a["indices"].dtype == np.int32 and a["indices"].max() < SMALL["columns"]
    # distinct and ascending within each row
    starts = np.repeat(a["indptr"][:-1], per_row)
    step = np.diff(a["indices"].astype(np.int64))
    within = (np.arange(1, len(a["indices"])) - starts[1:]) > 0
    assert np.all(step[within] > 0)
    assert np.all(a["values"] == 1.0) and set(np.unique(a["labels"])) == {0.0, 1.0}
    # popularity: the most used column is in far more rows than the median one
    counts = np.bincount(a["indices"], minlength=SMALL["columns"])
    assert counts.max() > 50 * max(np.median(counts), 1)


def test_another_seed_only_permutes_the_rows():
    a, c = _arrays(permutation_seed=7), _arrays(permutation_seed=8)
    assert not np.array_equal(a["labels"], c["labels"])

    def rows(x):
        ends = x["indptr"]
        return sorted((tuple(x["indices"][ends[i]:ends[i + 1]]), x["labels"][i])
                      for i in range(len(x["labels"])))

    assert rows(a) == rows(c)


def _delta(before: dict, names) -> dict:
    after = obs.get_registry().snapshot()["counters"]
    return {n: after.get(n, 0) - before.get(n, 0) for n in names}


def test_the_window_counters_count_the_layout():
    """A hand-built layout: 3 rows over 300 columns, 6 nonzeros in windows
    0, 1 and 2 (128 columns each) and padding slots of value 0, by the
    native build and by numpy's."""
    idx = np.array([[0, 129, 256], [1, 2, 0], [257, 0, 0]], dtype=np.int32)
    val = np.array([[1.0, 2.0, 3.0], [4.0, 5.0, 0.0], [6.0, 0.0, 0.0]], dtype=np.float32)
    names = ("windows.nnz", "windows.slots", "windows.instances")
    for native in (True, False):
        before = obs.get_registry().snapshot()["counters"]
        layout = tsw.build_column_windows_numpy(idx, val, 300, native=native)
        got = _delta(before, names)
        w_inst, length = layout["rows"].shape
        assert got["windows.slots"] == w_inst * length
        assert got["windows.instances"] == w_inst
        assert got["windows.nnz"] == int(np.count_nonzero(layout["vals"])) == 6


def test_the_owlqn_counters_count_iterations_and_trials():
    a = _arrays(permutation_seed=11)
    batch = to_device_sparse_batch(_data(a), dtype=torch.float64, device="cpu")
    names = ("owlqn.iterations", "owlqn.trials")
    before = obs.get_registry().snapshot()["counters"]
    (m,) = train_glm_grid(batch, _config(6), [LAMBDA], warm_start=False,
                          num_features=a["columns"], device="cpu")
    got = _delta(before, names)
    assert got["owlqn.iterations"] == int(m.result.iterations) == 6
    # every iteration tries at least once; the first halves its way down
    assert got["owlqn.trials"] >= got["owlqn.iterations"]
    assert got["owlqn.trials"] == int(m.result.n_evals) - 2  # less the two start points
