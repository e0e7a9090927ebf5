"""Port parity: host data modules and device batching against photon_tpu.

``csr_to_ell``, ``to_device_batch``, ``to_device_sparse_batch`` (with the
window layout) and ``to_device_auto_batch`` give arrays identical to the
JAX package's; ``choose_sparse`` agrees on a grid of shapes; sampling,
statistics, validation, the LIBSVM reader (on a file written to
``tmp_path``), the train/validation split and the box-constraint parser
give identical results.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from photon_tpu.data import dataset as jds
from photon_tpu.data import libsvm as jlibsvm
from photon_tpu.data import sampling as jsampling
from photon_tpu.data import stats as jstats
from photon_tpu.data import validators as jval
from photon_tpu.data.index_map import DefaultIndexMap as JIndexMap
from photon_tpu.data.index_map import feature_key
from photon_tpu.optimize import constraints as jcon
from photon_tpu.types import TaskType as JTask
from photon_tpu_torch.data import dataset as tds
from photon_tpu_torch.data import libsvm as tlibsvm
from photon_tpu_torch.data import sampling as tsampling
from photon_tpu_torch.data import stats as tstats
from photon_tpu_torch.data import validators as tval
from photon_tpu_torch.data.index_map import DefaultIndexMap as TIndexMap
from photon_tpu_torch.optimize import constraints as tcon
from photon_tpu_torch.types import TaskType as TTask


def _csr(seed=0, n=37, d=23):
    """CSR arrays with ragged rows (some empty) and an intercept column."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 7, size=n)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    indices = np.concatenate(
        [np.sort(rng.choice(d, size=c, replace=False)) for c in counts]
    ).astype(np.int32)
    values = rng.standard_normal(int(indptr[-1]))
    labels = (rng.uniform(size=n) > 0.5).astype(np.float64)
    offsets = 0.1 * rng.standard_normal(n)
    weights = rng.uniform(0.5, 2.0, size=n)
    return indptr, indices, values, labels, offsets, weights, d


def _datasets(seed=0, **kw):
    arrays = _csr(seed, **kw)
    return jds.DataSet(*arrays), tds.DataSet(*arrays)


def _fields_equal(got, want, fields):
    for f in fields:
        g, w = getattr(got, f), getattr(want, f)
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype, (f, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("pad_rows", [None, 48])
@pytest.mark.parametrize("multiple", [1, 8])
def test_csr_to_ell_identical(multiple, pad_rows):
    indptr, indices, values, *_ = _csr(1)
    want = jds.csr_to_ell(indptr, indices, values, np.float64, multiple, pad_rows)
    got = tds.csr_to_ell(indptr, indices, values, np.float64, multiple, pad_rows)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_to_device_batch_identical(dtype):
    jd, td = _datasets(2)
    want = jds.to_device_batch(jd, dtype=getattr(np, dtype))
    got = tds.to_device_batch(td, dtype=getattr(torch, dtype), device="cpu")
    _fields_equal(got, want, ("features", "labels", "offsets", "weights"))
    assert got.features.shape[0] % 8 == 0 and got.features.shape[0] > jd.num_samples


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_to_device_sparse_batch_identical(dtype, monkeypatch):
    jd, td = _datasets(3)
    monkeypatch.setenv("PHOTON_SPARSE_WINDOWS", "1")  # the JAX CPU default builds none
    want = jds.to_device_sparse_batch(jd, dtype=getattr(np, dtype))
    got = tds.to_device_sparse_batch(
        td, dtype=getattr(torch, dtype), device="cpu", column_windows=True
    )
    _fields_equal(got, want, ("indices", "values", "labels", "offsets", "weights"))
    _fields_equal(got.windows, want.windows, ("rows", "lcols", "vals", "inst2win", "iota"))
    monkeypatch.setenv("PHOTON_SPARSE_WINDOWS", "0")
    assert tds.to_device_sparse_batch(td, device="cpu").windows is None


def test_to_device_auto_batch_picks_the_same_layout(monkeypatch):
    monkeypatch.setattr(jds, "AUTO_SPARSE_DENSE_BYTES", 1024)
    monkeypatch.setattr(tds, "AUTO_SPARSE_DENSE_BYTES", 1024)
    for n, d in ((37, 23), (300, 400)):
        jd, td = _datasets(4, n=n, d=d)
        want = jds.to_device_auto_batch(jd)
        got = tds.to_device_auto_batch(td, device="cpu")
        assert type(got).__name__ == type(want).__name__
    assert type(got).__name__ == "SparseBatch"


def test_batches_default_to_cuda_and_never_fall_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    _, td = _datasets(5)
    for fn in (tds.to_device_batch, tds.to_device_sparse_batch, tds.to_device_auto_batch):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(td)


def test_choose_sparse_agrees_on_a_grid():
    for rows in (0, 1, 1000, 1 << 16, 1 << 20):
        for cols in (1, 124, 2048, 1 << 20):
            for density in (0.001, 0.1, 0.3, 1.0):
                for itemsize in (4, 8):
                    nnz = int(rows * cols * density)
                    assert tds.choose_sparse(rows, cols, nnz, itemsize) == jds.choose_sparse(
                        rows, cols, nnz, itemsize
                    ), (rows, cols, density, itemsize)


FIELDS = ("indptr", "indices", "values", "labels", "offsets", "weights")


@pytest.mark.parametrize("fraction", [0.0, 0.25, 0.5])
def test_train_validation_split_identical(fraction):
    jd, td = _datasets(6, n=90)
    for got, want in zip(
        tds.train_validation_split(td, fraction, seed=3),
        jds.train_validation_split(jd, fraction, seed=3),
    ):
        _fields_equal(got, want, FIELDS)


@pytest.mark.parametrize("classification", [True, False])
def test_down_samplers_identical(classification):
    jd, td = _datasets(7, n=200)
    for rate in (0.0, 0.2, 0.6, 1.0):
        js = jsampling.build_down_sampler(classification, rate)
        ts = tsampling.build_down_sampler(classification, rate)
        assert (js is None) == (ts is None) == (rate in (0.0, 1.0))
        if js is not None:
            _fields_equal(ts.downsample(td, seed=5), js.downsample(jd, seed=5), FIELDS)


def test_basic_statistical_summary_identical():
    arrays = list(_csr(8, n=40, d=9))
    # a fully dense column (no implicit zeros) and negative-only columns
    n = arrays[0].shape[0] - 1
    x = jds.DataSet(*arrays).to_dense(np.float64)
    x[:, 2] = np.random.default_rng(0).standard_normal(n)
    x[:, 3] = -np.abs(x[:, 3])
    jd = jds.DataSet.from_dense(x, arrays[3])
    td = tds.DataSet.from_dense(x, arrays[3])
    want, got = jstats.BasicStatisticalSummary.of(jd), tstats.BasicStatisticalSummary.of(td)
    for f in ("mean", "variance", "count", "num_nonzeros", "max", "min", "norm_l1", "norm_l2", "mean_abs"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


def _validation_outcome(mod, task, data, mode):
    try:
        mod.validate(data, task, mod.DataValidationType[mode])
    except mod.DataValidationError as e:
        return str(e)
    return None


@pytest.mark.parametrize("mode", ["VALIDATE_FULL", "VALIDATE_SAMPLE", "VALIDATE_DISABLED"])
def test_validators_identical(mode):
    base = list(_csr(9, n=120))
    cases = {
        "ok": base,
        "nan_value": [base[0], base[1], np.where(np.arange(len(base[2])) % 3 == 0, np.nan, base[2]), *base[3:]],
        "labels_-1_2": [*base[:3], np.where(base[3] > 0, 2.0, -1.0), *base[4:]],
        "zero_weight": [*base[:5], np.where(np.arange(120) % 2 == 0, 0.0, base[5]), base[6]],
        "negative_count": [*base[:3], base[3] - 0.5, *base[4:]],
    }
    outcomes = set()
    for name, arrays in cases.items():
        for task in ("LOGISTIC_REGRESSION", "POISSON_REGRESSION", "LINEAR_REGRESSION"):
            want = _validation_outcome(jval, JTask[task], jds.DataSet(*arrays), mode)
            got = _validation_outcome(tval, TTask[task], tds.DataSet(*arrays), mode)
            assert got == want, (name, task)
            outcomes.add(want)
    assert (len(outcomes) > 2) == (mode != "VALIDATE_DISABLED")


LIBSVM = """\
+1 1:0.5 3:1.25 7:-2 # a comment
-1 2:1 3:0.5
# a line of comment only

+1 5:3.5 9:1
-1
+1 1:1 2:2 3:3 4:4
"""


@pytest.mark.parametrize(
    "kw",
    [{}, {"num_features": 5}, {"zero_based": True}, {"add_intercept": False}, {"binary_labels_to_01": False}],
    ids=["default", "clipped", "zero-based", "no-intercept", "raw-labels"],
)
def test_read_libsvm_identical(tmp_path, kw):
    path = tmp_path / "data.libsvm"
    path.write_text(LIBSVM)
    want = jlibsvm.read_libsvm(str(path), **kw)
    got = tlibsvm.read_libsvm(str(path), **kw)
    assert got.num_features == want.num_features
    _fields_equal(got, want, FIELDS)


CONSTRAINTS = [
    [{"name": "age", "term": "", "lowerBound": 0.0, "upperBound": 1.0}],
    [{"name": "geo", "term": "*", "lowerBound": -1.0}],
    [{"name": "*", "term": "*", "upperBound": 2.0}],
    [{"name": "age", "term": "", "upperBound": 0.5}, {"name": "geo", "term": "us", "lowerBound": -0.5, "upperBound": None}],
    [{"name": "missing", "term": "x", "lowerBound": 0.0}],
    # refused by both
    [{"name": "age", "lowerBound": 0.0}],
    [{"name": "age", "term": ""}],
    [{"name": "age", "term": "", "lowerBound": 1.0, "upperBound": 0.0}],
    [{"name": "*", "term": "x", "lowerBound": 0.0}],
    [{"name": "*", "term": "*", "lowerBound": 0.0}, {"name": "age", "term": "", "lowerBound": 0.0}],
    [{"name": "geo", "term": "*", "lowerBound": 0.0}, {"name": "geo", "term": "us", "lowerBound": 0.0}],
    [{"name": "age", "term": "", "lowerBound": "low"}],
    {"name": "age"},
]


def _index_maps():
    keys = [feature_key("age"), feature_key("income")] + [
        feature_key("geo", t) for t in ("ca", "us", "uk")
    ]
    return JIndexMap.from_keys(keys), TIndexMap.from_keys(keys)


@pytest.mark.parametrize("i", range(len(CONSTRAINTS)))
def test_constraint_parsing_identical(i):
    text = json.dumps(CONSTRAINTS[i])
    jmap, tmap = (dict(m) for m in _index_maps())
    assert jmap == tmap
    try:
        want = jcon.parse_constraint_string(text, jmap)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tcon.parse_constraint_string(text, tmap)
        assert str(got.value) == str(e)
        return
    got = tcon.parse_constraint_string(text, tmap)
    assert got == want
    for g, w in zip(tcon.bounds_arrays(got, len(tmap)), jcon.bounds_arrays(want, len(jmap))):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g, w)


def test_bad_json_and_out_of_range_index_refused_by_both():
    for mod in (jcon, tcon):
        with pytest.raises(ValueError, match="not valid JSON"):
            mod.parse_constraint_string("[{", {})
        with pytest.raises(ValueError, match="out of range"):
            mod.bounds_arrays({7: (0.0, 1.0)}, 3)
