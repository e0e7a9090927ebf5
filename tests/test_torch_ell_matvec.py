"""The sparse ELL forward pass X·v (``csrc/ell_matvec.cu``) and the rule
that sends a pass to it.

The CPU tests pin the dispatch rule (``ops.ell_matvec.plain_reason``): the
passes that keep the plain gather and row sum, each counted in
``ell.passes_plain``, the kernel's launch shape, and the wrapper's refusals.
The ``cuda`` tests hold the kernel to the plain version on the card:
``python -m pytest --noconftest -m cuda tests/test_torch_ell_matvec.py``.
No JAX here.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from photon_tpu_torch import obs
from photon_tpu_torch.data.dataset import DataSet, to_device_sparse_batch
from photon_tpu_torch.game.config import FeatureRepresentation
from photon_tpu_torch.model_training import train_glm_grid
from photon_tpu_torch.ops import cuda_build
from photon_tpu_torch.ops import ell_matvec as em
from photon_tpu_torch.ops.objective import matvec
from photon_tpu_torch.optimize import lane_lbfgs
from photon_tpu_torch.optimize.common import OptimizerConfig
from photon_tpu_torch.optimize.problem import (
    GLMProblemConfig,
    RegularizationContext,
    RegularizationType,
)
from photon_tpu_torch.types import OptimizerType, SparseBatch, TaskType


@pytest.fixture(autouse=True)
def _clean():
    obs.reset()
    yield
    obs.reset()


def _counters():
    c = obs.get_registry().snapshot()["counters"]
    return c.get("ell.passes_fused", 0), c.get("ell.passes_plain", 0)


def _block(n, k, d, *, seed=0, dtype=torch.float32, value_dtype=None, device="cpu",
           empty_rows=(), fill=None):
    """indices [n, k] int32 over ``d`` columns and values [n, k], the last
    k − ``fill`` slots of each row padding (index 0, value 0), the rows in
    ``empty_rows`` padding alone; v [d] N(0, 1)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, d, size=(n, k)).astype(np.int32)
    val = rng.standard_normal((n, k))
    fill = k if fill is None else fill
    idx[:, fill:], val[:, fill:] = 0, 0.0
    idx[list(empty_rows)], val[list(empty_rows)] = 0, 0.0
    v = torch.as_tensor(rng.standard_normal(d), dtype=dtype, device=device)
    vals = torch.as_tensor(val, device=device).to(value_dtype or dtype)
    return torch.as_tensor(idx, device=device), vals, v


# -- on the CPU ----------------------------------------------------------------


def test_the_plain_version_is_the_gather_and_row_sum():
    idx, val, v = _block(50, 8, 30, dtype=torch.float64, fill=5)
    want = (v.numpy()[idx.numpy()] * val.numpy()).sum(-1)
    np.testing.assert_allclose(em.ell_matvec_plain(idx, val, v).numpy(), want, rtol=1e-14)


@pytest.mark.parametrize("k,aligned,shape", [
    (8, True, (4, 2)),      # the GAME fixed effect
    (40, True, (4, 8)),     # a kdda-shaped GLM
    (13, True, (1, 8)),     # rows not on 16-byte boundaries
    (8, False, (1, 8)),
    (4, True, (4, 1)),
    (1, True, (1, 1)),
    (256, True, (4, 32)),
    (1000, True, (4, 32)),
])
def test_launch_shape(k, aligned, shape):
    """16-byte chunks where every row starts on a 16-byte boundary; the most
    lanes a row, a power of two up to a warp, that leaves none without a
    chunk."""
    assert em.launch_shape(k, aligned) == shape


def _on_cuda(t):
    """``t`` as the rule sees a CUDA tensor (the CPU tests reach every
    branch of the rule without a card)."""
    class Fake:
        device = torch.device("cuda", 0)
        dtype = t.dtype
        shape = t.shape

        def dim(self):
            return t.dim()

        def is_contiguous(self):
            return t.is_contiguous()

        def numel(self):
            return t.numel()

    return Fake()


def test_the_rule_takes_a_cuda_block_it_can_run():
    idx, val, v = _block(20, 8, 10)
    assert em.plain_reason(_on_cuda(idx), _on_cuda(val), _on_cuda(v)) is None
    for value_dtype in (torch.float64, torch.bfloat16):
        assert em.plain_reason(_on_cuda(idx), _on_cuda(val.to(value_dtype)),
                               _on_cuda(v.double())) is None


@pytest.mark.parametrize("case,reason", [
    ("cpu", "on cpu"),
    ("lanes", "v of 2 dims (lanes)"),
    ("int64", "indices torch.int64"),
    ("v_float16", "v torch.float16"),
    ("values_float16", "values torch.float16"),
    ("strided_v", "not contiguous"),
    ("three_dims", "indices and values not one [N, K] block"),
    ("mismatched", "indices and values not one [N, K] block"),
    ("empty", "empty block"),
])
def test_the_rule_keeps_the_plain_version(case, reason):
    idx, val, v = _block(20, 8, 10)
    on = _on_cuda
    args = {
        "cpu": (idx, val, v),
        "lanes": (on(idx), on(val), on(v.expand(3, 10))),
        "int64": (on(idx.long()), on(val), on(v)),
        "v_float16": (on(idx), on(val), on(v.half())),
        "values_float16": (on(idx), on(val.half()), on(v)),
        "strided_v": (on(idx), on(val), on(torch.zeros(20)[::2])),
        "three_dims": (on(idx.expand(2, 20, 8)), on(val.expand(2, 20, 8)), on(v)),
        "mismatched": (on(idx), on(val[:, :4]), on(v)),
        "empty": (on(idx[:0]), on(val[:0]), on(v)),
    }[case]
    assert em.plain_reason(*args) == reason


@pytest.mark.parametrize("case", ["cpu", "int64", "bf16_values", "float64"])
def test_a_cpu_pass_runs_the_plain_version_and_counts_as_plain(case):
    """Every pass the rule keeps off the kernel is the plain version, bit
    for bit, counted once in ``ell.passes_plain`` whether or not telemetry
    is on, and launches nothing."""
    idx, val, v = _block(64, 8, 40, seed=3, fill=6)
    if case == "int64":
        idx = idx.long()
    elif case == "bf16_values":
        val = val.to(torch.bfloat16)
    elif case == "float64":
        val, v = val.double(), v.double()
    launches = cuda_build.launch_count("ell_matvec")
    assert torch.equal(em.ell_matvec(idx, val, v), em.ell_matvec_plain(idx, val, v))
    obs.enable()
    try:
        em.ell_matvec(idx, val, v)
    finally:
        obs.disable()
    assert _counters() == (0, 2)
    assert cuda_build.launch_count("ell_matvec") == launches


def test_a_pass_lands_in_the_route_record():
    """Each pass is recorded under ("ell", device, route) in the
    process-lifetime route record, which ``obs.reset()`` leaves counting."""
    idx, val, v = _block(16, 8, 8)
    key = ("ell", "cpu", "on cpu")
    before = cuda_build.routes[key]
    em.ell_matvec(idx, val, v)
    obs.reset()
    em.ell_matvec(idx.long(), val, v)
    assert cuda_build.routes[key] - before == 1
    assert cuda_build.routes[("ell", "cpu", "indices torch.int64")] >= 1
    assert _counters() == (0, 1)


def test_the_route_record_is_one_for_every_kernel():
    """The solvers' module re-exports the one route record that the ops
    layer keeps: an ELL pass and an L-BFGS solve land in the same counter."""
    assert lane_lbfgs.routes is cuda_build.routes
    assert lane_lbfgs.record_route is cuda_build.record_route
    assert lane_lbfgs.ROUTE_TALLIES is cuda_build.ROUTE_TALLIES
    assert set(cuda_build.ROUTE_TALLIES) >= {"lanes", "solo", "ell"}


def test_matvec_on_a_sparse_batch_asks_the_rule_once_a_pass():
    idx, val, v = _block(32, 8, 16, dtype=torch.float64, seed=5)
    zeros = torch.zeros(32, dtype=torch.float64)
    batch = SparseBatch(indices=idx, values=val, labels=zeros, offsets=zeros, weights=zeros + 1)
    assert torch.equal(matvec(batch, v), em.ell_matvec_plain(idx, val, v))
    matvec(batch, v)
    assert _counters() == (0, 2)


def test_the_wrapper_raises_on_what_the_kernel_does_not_take():
    """``ell_matvec_cuda`` launches or raises: a CPU tensor is refused
    before any library is loaded."""
    idx, val, v = _block(8, 8, 4)
    with pytest.raises(ValueError, match="CUDA"):
        em.ell_matvec_cuda(idx, val, v)


def test_the_fixed_effect_places_its_column_ids_as_int32():
    """The GAME fixed effect's ELL ids stay int32 as the host ELL makes
    them, so the kernel takes its passes on the card (its rule keeps int64
    ids on the plain version)."""
    from test_torch_lane_lbfgs import _estimator, _game_data

    est = _estimator()
    est.coordinate_configs["fixed"] = dataclasses.replace(
        est.coordinate_configs["fixed"], representation=FeatureRepresentation.SPARSE)
    coords = est._build_coordinates(_game_data())
    assert isinstance(coords["fixed"].batch, SparseBatch)
    assert coords["fixed"].batch.indices.dtype == torch.int32


# -- on the card ---------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the chip: pytest -m cuda")
    return torch.device("cuda")


def _reference(idx, val, v):
    """The plain version in float64 on the values as v's type holds them."""
    return em.ell_matvec_plain(idx, val.to(v.dtype).double(), v.double())


def _bound(idx, val, v):
    """Whatever order a row's K products are summed in, with one rounding a
    slot, |error| ≤ 1.01·K·u·Σ|w·x| (Higham, Accuracy and Stability of
    Numerical Algorithms, §3.1), u of v's type; the float64 reference adds
    K·2⁻⁵³ of the same sum."""
    k = idx.shape[1]
    u = torch.finfo(v.dtype).eps / 2
    return 1.01 * k * (u + 2.0**-53) * em.ell_matvec_plain(
        idx, val.to(v.dtype).double().abs(), v.double().abs())


@pytest.mark.cuda
@pytest.mark.parametrize("k,fill", [(8, 6), (13, 13), (40, 37)])
@pytest.mark.parametrize("dtype,value_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.float64, torch.float64), (torch.float64, torch.float32),
    (torch.float64, torch.bfloat16), (torch.float32, torch.float64)])
def test_the_kernel_matches_the_plain_version(k, fill, dtype, value_dtype):
    """Within the summation bound of the float64 reference, as is the plain
    version in the same types; 4,133 rows (not a whole number of blocks at
    any group size), all-padding rows among them, padding slots in each."""
    dev = _card()
    idx, val, v = _block(4133, k, 5000, seed=k, dtype=dtype, value_dtype=value_dtype,
                         device=dev, empty_rows=(0, 17, 4132), fill=fill)
    got = em.ell_matvec_cuda(idx, val, v)
    plain = em.ell_matvec_plain(idx, val, v)
    assert got.dtype == dtype and got.shape == (4133,)
    want, bound = _reference(idx, val, v), _bound(idx, val, v)
    assert bool(((got.double() - want).abs() <= bound).all())
    assert bool(((plain.double() - want).abs() <= bound).all())
    assert torch.equal(got[[0, 17, 4132]], torch.zeros(3, dtype=dtype, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [8, 13, 40])
def test_a_launch_repeats_bit_for_bit(k):
    dev = _card()
    idx, val, v = _block(20000, k, 100000, seed=1, device=dev)
    first = em.ell_matvec_cuda(idx, val, v)
    for _ in range(3):
        assert torch.equal(em.ell_matvec_cuda(idx, val, v), first)


@pytest.mark.cuda
def test_an_unaligned_block_takes_one_slot_chunks():
    """A row slice that starts off a 16-byte boundary still runs (one-slot
    chunks) and agrees with the plain version."""
    dev = _card()
    # views that start 4 bytes past an allocation
    raw_i = torch.empty(1000 * 8 + 1, dtype=torch.int32, device=dev)
    raw_v = torch.empty(1000 * 8 + 1, dtype=torch.float32, device=dev)
    ii = raw_i[1:].view(1000, 8)
    vv = raw_v[1:].view(1000, 8)
    src_i, src_v, v = _block(1000, 8, 300, seed=2, device=dev)
    ii.copy_(src_i)
    vv.copy_(src_v)
    assert ii.data_ptr() % 16 != 0
    got = em.ell_matvec_cuda(ii, vv, v)
    assert bool(((got.double() - _reference(ii, vv, v)).abs() <= _bound(ii, vv, v)).all())


@pytest.mark.cuda
def test_a_pass_on_the_card_launches_once_and_counts_as_fused():
    dev = _card()
    idx, val, v = _block(500, 8, 64, device=dev)
    zeros = torch.zeros(500, device=dev)
    batch = SparseBatch(indices=idx, values=val, labels=zeros, offsets=zeros, weights=zeros + 1)
    launches = cuda_build.launch_count("ell_matvec")
    for i in range(1, 4):
        matvec(batch, v)
        assert cuda_build.launch_count("ell_matvec") - launches == i
        assert _counters() == (i, 0)
    # int64 ids on the card keep the plain version
    matvec(batch._replace(indices=idx.long()), v)
    assert cuda_build.launch_count("ell_matvec") - launches == 3
    assert _counters() == (3, 1)


@pytest.mark.cuda
def test_the_wrapper_raises_on_the_card_for_what_the_kernel_does_not_take():
    dev = _card()
    idx, val, v = _block(16, 8, 8, device=dev)
    with pytest.raises(TypeError):
        em.ell_matvec_cuda(idx.long(), val, v)
    with pytest.raises(TypeError):
        em.ell_matvec_cuda(idx, val, v.half())
    with pytest.raises(ValueError):
        em.ell_matvec_cuda(idx[:, ::2], val[:, ::2], v)
    with pytest.raises(ValueError):
        em.ell_matvec_cuda(idx, val, v.expand(2, 8))


@pytest.mark.cuda
def test_a_kdda_shaped_fit_takes_the_kernel_for_every_pass():
    """An elastic-net OWL-QN fit over kdda's row shape (36-37 Zipf-popular
    columns a row, K = 40) at 20,000 rows: every ELL forward pass of the
    fit (its start, each trial, the judge's margins) launches the kernel."""
    from port_bench.gen.kdd2010 import kdd2010_arrays

    dev = _card()
    a = kdd2010_arrays(2010, rows=20000, columns=200000, nonzeros_per_row=36.349,
                       zipf_exponent=1.0, signal_share=0.01, intercept=1.7, device=dev)
    n = len(a["labels"])
    data = DataSet(indptr=a["indptr"], indices=a["indices"], values=a["values"],
                   labels=a["labels"], offsets=np.zeros(n), weights=np.ones(n),
                   num_features=a["columns"])
    batch = to_device_sparse_batch(data, dtype=torch.float32, device=dev, column_windows=True)
    assert batch.indices.shape[1] == 40
    cfg = GLMProblemConfig(
        task=TaskType.LOGISTIC_REGRESSION, optimizer=OptimizerType.OWLQN,
        optimizer_config=OptimizerConfig(max_iterations=10, tolerance=-1.0),
        regularization=RegularizationContext(RegularizationType.ELASTIC_NET, 0.5))
    launches = cuda_build.launch_count("ell_matvec")
    (model,) = train_glm_grid(batch, cfg, [2.0], warm_start=False,
                              num_features=a["columns"], device=dev)
    fused, plain = _counters()
    assert plain == 0 and fused >= 11
    assert cuda_build.launch_count("ell_matvec") - launches == fused
    z = matvec(batch, model.model.coefficients.means)
    want = em.ell_matvec_plain(batch.indices, batch.values, model.model.coefficients.means)
    assert float((z - want).norm() / want.norm()) < 1e-6
