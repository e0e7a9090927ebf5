"""Port parity: the column-window layout and the windowed Xᵀr.

The layout arrays must be identical to photon_tpu's build; the plain Xᵀr
(what the CUDA kernel is held against on the card) must match the JAX
one-hot lowering at float64 and the Pallas kernel in interpret mode at
float32. The CUDA kernel itself runs only on the card (marked ``cuda``).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.ops import sparse_windows as jsw
from photon_tpu_torch.ops import sparse_windows as tsw

# the JAX layout's ``bounds`` feeds only its prefix lowering; the port
# has no such lowering and does not build it
FIELDS = ("rows", "lcols", "vals", "inst2win", "iota")


def _random_ell(rng, n, k, d, hot_column=False, zero_slots=True, dtype=np.float32):
    idx = rng.integers(0, d, size=(n, k)).astype(np.int32)
    val = rng.standard_normal((n, k)).astype(dtype)
    if hot_column:
        idx[:, 0] = 0
        val[:, 0] = 1.0
    if zero_slots:
        val[rng.uniform(size=(n, k)) < 0.2] = 0.0
    return idx, val


# (n, k, d, hot, build kwargs) — the layouts of tests/test_sparse_windows.py
CASES = {
    f"d{d}-hot{int(hot)}": (257, 5, d, hot, dict(window=32, instance_cap=128, chunk=16))
    for d in (64, 300, 1024)
    for hot in (False, True)
}
CASES["pad-to-8"] = (100, 3, 40, False, dict(window=16, instance_cap=64))
CASES["bounds"] = (300, 4, 96, True, dict(window=32, instance_cap=64))
CASES["nondefault-chunk"] = (3000, 2, 8, True, dict(window=8, instance_cap=1536, chunk=512))
CASES["deep-spill"] = (5000, 8, 256, True, dict(window=64, instance_cap=4096))


def _case(name, dtype=np.float32):
    n, k, d, hot, kw = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    idx, val = _random_ell(rng, n, k, d, hot_column=hot, dtype=dtype)
    r = rng.standard_normal(n).astype(dtype)
    return idx, val, d, r, kw


@pytest.mark.parametrize("name", sorted(CASES))
def test_layout_identical_to_jax_build(name):
    idx, val, d, _, kw = _case(name)
    want = jsw.build_column_windows(idx, val, d, host=True, **kw)
    got = tsw.build_column_windows_numpy(idx, val, d, **kw)
    for f in FIELDS:
        a, b = np.asarray(getattr(want, f)), got[f]
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_rmatvec_matches_onehot_f64(name):
    idx, val, d, r, kw = _case(name, dtype=np.float64)
    jw = jsw.build_column_windows(idx, val, d, **kw)
    want = np.asarray(jsw.rmatvec_windows_onehot(jw, jnp.asarray(r), d))
    tw = tsw.build_column_windows(idx, val, d, dtype=torch.float64, **kw)
    got = tsw.windowed_rmatvec(tw, torch.as_tensor(r), d).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_rmatvec_matches_pallas_interpret_f32(name):
    idx, val, d, r, kw = _case(name)
    jw = jsw.build_column_windows(idx, val, d, **kw)
    want = np.asarray(
        jsw.rmatvec_windows_pallas(jw, jnp.asarray(r), d, interpret=True)
    )
    tw = tsw.build_column_windows(idx, val, d, dtype=torch.float32, **kw)
    got = tsw.windowed_rmatvec(tw, torch.as_tensor(r), d).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-4)


def test_column_windows_from_jax_arrays():
    """A JAX layout carried across as numpy drives the port's Xᵀr."""
    idx, val, d, r, kw = _case("d300-hot1", dtype=np.float64)
    jw = jsw.build_column_windows(idx, val, d, **kw)
    tw = tsw.column_windows_from_numpy({f: np.asarray(getattr(jw, f)) for f in FIELDS})
    got = tsw.windowed_rmatvec(tw, torch.as_tensor(r), d).numpy()
    want = np.zeros(d)
    np.add.at(want, idx.reshape(-1), (val * r[:, None]).reshape(-1))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_cpu_tensor_does_not_launch_the_kernel():
    idx, val, d, r, kw = _case("d64-hot1")
    tw = tsw.build_column_windows(idx, val, d, **kw)
    before = tsw.windowed_rmatvec.launches
    tsw.windowed_rmatvec(tw, torch.as_tensor(r), d)
    assert tsw.windowed_rmatvec.launches == before == 0


def test_kernel_entry_refuses_cpu_tensors():
    idx, val, d, r, kw = _case("d64-hot0")
    tw = tsw.build_column_windows(idx, val, d, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        tsw.windowed_rmatvec_cuda(tw, torch.as_tensor(r), d)


def test_window_policy():
    idx, val, d, _, _ = _case("d1024-hot0")
    cpu = torch.device("cpu")
    assert tsw.maybe_build_windows(idx, val, d, device=cpu) is None
    forced = tsw.maybe_build_windows(idx, val, d, device=cpu, force=True)
    assert forced is not None and forced.window == 128
    assert forced.rows.shape[0] % 8 == 0


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """On the card: the CUDA kernel against the plain version (float32),
    bit-identical across two runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the chip: pytest -m cuda")
    dev = torch.device("cuda")
    for name in sorted(CASES):
        idx, val, d, r, kw = _case(name)
        tw = tsw.build_column_windows(idx, val, d, dtype=torch.float32, device=dev, **kw)
        rt = torch.as_tensor(r, device=dev)
        before = tsw.windowed_rmatvec.launches
        got = tsw.windowed_rmatvec(tw, rt, d)
        again = tsw.windowed_rmatvec(tw, rt, d)
        want = tsw.windowed_rmatvec_plain(tw, rt, d)
        torch.cuda.synchronize()
        assert tsw.windowed_rmatvec.launches == before + 2
        assert torch.equal(got, again), name
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
