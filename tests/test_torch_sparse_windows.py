"""Port parity: the column-window layout and the windowed Xᵀr.

The layout arrays must be identical to photon_tpu's build; the plain Xᵀr
(what the CUDA kernel is held against on the card) must match the JAX
one-hot lowering at float64 and the Pallas kernel in interpret mode at
float32. The CUDA kernel itself runs only on the card (marked ``cuda``);
its summation plan — which CTA takes which tiles, which windows need the
fix-up, and the order of the sums — is checked here in plain code.
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


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.int32, torch.int64])
def test_kernel_entry_refuses_other_value_types(dtype):
    idx, val, d, r, kw = _case("d64-hot0")
    tw = tsw.build_column_windows(idx, val, d, **kw)
    tw = tw._replace(vals=tw.vals.to(dtype))
    with pytest.raises(TypeError, match="float32 or float64"):
        tsw.windowed_rmatvec_cuda(tw, torch.as_tensor(r).to(dtype), d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_entry_takes_float32_and_float64(dtype):
    """Both value types pass the type check; on the CPU the entry then
    refuses the device, as it must without a card."""
    idx, val, d, r, kw = _case("d64-hot0")
    tw = tsw.build_column_windows(idx, val, d, dtype=dtype, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        tsw.windowed_rmatvec_cuda(tw, torch.as_tensor(r).to(dtype), d)


def test_kernel_entry_refuses_instance_length_not_multiple_of_4():
    """The kernel's bulk copies move whole 16-byte groups of an instance."""
    idx, val, d, r, kw = _case("d64-hot0")
    tw = tsw.build_column_windows(idx, val, d, **kw)
    tw = tw._replace(**{f: getattr(tw, f)[:, :6].contiguous() for f in ("rows", "lcols", "vals")})
    with pytest.raises(ValueError, match="multiple of 4"):
        tsw.windowed_rmatvec_cuda(tw, torch.as_tensor(r), d)


# ---------------------------------------------------------------------------
# The kernel's summation plan, in plain code: a persistent grid of CTAs over
# contiguous tile ranges, per-(CTA, window) partials, and a fix-up that
# sums each split window's partials in CTA order.
# ---------------------------------------------------------------------------

def _config5_shaped(n=12288, d=1 << 17, k=24, seed=5):
    """bench config 5's FE at a few thousand rows: 2¹⁷ columns, 24
    nonzeros per row with the intercept in slot 0 (one hot window that
    spills into 4 instances), window 128, L = 4096."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(1, d, size=(n, k)).astype(np.int32)
    idx[:, 0] = 0
    val = rng.standard_normal((n, k)) / np.sqrt(k)
    val[:, 0] = 1.0
    return idx, val, d, rng.standard_normal(n)


def _layout_inputs(name, dtype=np.float64):
    if name == "config5":
        idx, val, d, r = _config5_shaped()
        return idx, val.astype(dtype), d, r.astype(dtype), {}
    if name == "ragged-tiles":
        # L = 5000: tiles of 2048, 2048 and 904 slots
        rng = np.random.default_rng(11)
        idx, val = _random_ell(rng, 5000, 3, 512, hot_column=True, dtype=dtype)
        kw = dict(window=64, instance_cap=5000, chunk=1000)
        return idx, val, 512, rng.standard_normal(5000).astype(dtype), kw
    return _case(name, dtype=dtype)


def _tile_windows(name):
    idx, val, d, _, kw = _layout_inputs(name)
    arrays = tsw.build_column_windows_numpy(idx, val, d, **kw)
    return tsw.tile_windows(arrays["inst2win"], arrays["rows"].shape[1])


LAYOUTS = sorted(CASES) + ["config5", "ragged-tiles"]
#: 264 = two 256-thread CTAs on each of an H100's 132 SMs
GRIDS = (1, 3, 8, 264, 100_000)


def _two_level(win, r, dim, grid):
    """The kernel's order in plain PyTorch: each CTA sums its range of
    tiles window by window and writes a window's sum straight to out or,
    for a split window, to scratch[b, slot]; then each split window's
    partials are summed in CTA order."""
    w = win.window
    w_inst, length = win.rows.shape
    inst2win = win.inst2win.numpy()
    tile_win = tsw.tile_windows(inst2win, length)
    tpi = len(tile_win) // w_inst
    tile = tsw.kernel_tile(length)

    def slots(q):  # flat slot range of tile q
        inst, t = divmod(int(q), tpi)
        return inst * length + t * tile, inst * length + min((t + 1) * tile, length)

    bounds = tsw.work_partition(len(tile_win), grid)
    dest, split = tsw.fixup_plan(tile_win, bounds)
    nw = int(inst2win[-1]) + 1
    out = torch.full((max(nw * w, dim),), float("nan"), dtype=win.vals.dtype)
    out[nw * w:] = 0  # columns past the layout's last window
    scratch = torch.full((len(bounds) - 1, 2, w), float("nan"), dtype=win.vals.dtype)
    contrib = (win.vals * r[win.rows.long()]).reshape(-1)
    lcols = win.lcols.reshape(-1).long()
    for b in range(len(bounds) - 1):
        lo, hi = int(bounds[b]), int(bounds[b + 1])
        a, e = slots(lo)[0], slots(hi - 1)[1]
        for x in np.unique(tile_win[lo:hi]):
            insts = np.flatnonzero(inst2win == x)
            s0 = max(a, int(insts[0]) * length)
            s1 = min(e, (int(insts[-1]) + 1) * length)
            acc = torch.zeros(w, dtype=contrib.dtype).index_add_(
                0, lcols[s0:s1], contrib[s0:s1]
            )
            slot = np.flatnonzero(dest[b] == x)
            if slot.size:
                scratch[b, int(slot[0])] = acc
            else:
                assert torch.isnan(out[x * w:(x + 1) * w]).all(), "window written twice"
                out[x * w:(x + 1) * w] = acc
    for x, parts in split.items():
        ctas = [b for b, _ in parts]
        assert len(parts) >= 2 and ctas == list(range(ctas[0], ctas[0] + len(ctas)))
        assert torch.isnan(out[x * w:(x + 1) * w]).all(), "split window also written directly"
        total = scratch[parts[0]]
        for b, s in parts[1:]:
            total = total + scratch[b, s]
        out[x * w:(x + 1) * w] = total
    assert not torch.isnan(out).any(), "a window was never written"
    return out[:dim]


def test_tile_windows():
    # L = 4096: 256 threads × 8 slots, two tiles per instance
    np.testing.assert_array_equal(tsw.tile_windows([0, 0, 1], 4096), [0, 0, 0, 0, 1, 1])
    # L = 1536: 192 threads, one tile; L = 16: one warp, one ragged tile
    np.testing.assert_array_equal(tsw.tile_windows([0, 1], 1536), [0, 1])
    np.testing.assert_array_equal(tsw.tile_windows([3], 16), [3])
    # L = 5000: 256 threads, 3 tiles, the last one ragged
    np.testing.assert_array_equal(tsw.tile_windows([2], 5000), [2, 2, 2])
    idx, val, d, _, kw = _layout_inputs("ragged-tiles")
    assert tsw.build_column_windows_numpy(idx, val, d, **kw)["rows"].shape[1] == 5000


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("name", LAYOUTS)
def test_work_partition_covers_each_tile_once(name, grid):
    n_tiles = len(_tile_windows(name))
    bounds = tsw.work_partition(n_tiles, grid)
    assert len(bounds) == min(grid, n_tiles) + 1
    assert bounds[0] == 0 and bounds[-1] == n_tiles
    assert (np.diff(bounds) >= 1).all()  # in order, no overlap, none empty
    cover = np.concatenate([np.arange(a, b) for a, b in zip(bounds[:-1], bounds[1:])])
    np.testing.assert_array_equal(cover, np.arange(n_tiles))
    # tiles are equal work: range sizes differ by at most one
    assert np.ptp(np.diff(bounds)) <= 1


@pytest.mark.parametrize("name", LAYOUTS)
def test_fixup_plan_splits_only_windows_that_span_ctas(name):
    tile_win = _tile_windows(name)
    for grid in GRIDS:
        bounds = tsw.work_partition(len(tile_win), grid)
        dest, split = tsw.fixup_plan(tile_win, bounds)
        owners = {}
        for b in range(len(bounds) - 1):
            for x in np.unique(tile_win[bounds[b]:bounds[b + 1]]):
                owners.setdefault(int(x), []).append(b)
        assert sorted(split) == sorted(x for x, o in owners.items() if len(o) > 1)
        for x, parts in split.items():
            assert [b for b, _ in parts] == owners[x]
        # a CTA's two scratch slots never hold the same window
        both = (dest[:, 0] >= 0) & (dest[:, 1] >= 0)
        assert (dest[both, 0] != dest[both, 1]).all()
    if name == "config5":
        # the intercept window spills over two of an H100's 264 CTAs
        _, split = tsw.fixup_plan(tile_win, tsw.work_partition(len(tile_win), 264))
        assert 0 in split and len(split[0]) >= 2


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("name", LAYOUTS)
def test_two_level_order_matches_plain_f64(name, grid):
    idx, val, d, r, kw = _layout_inputs(name)
    tw = tsw.build_column_windows(idx, val, d, dtype=torch.float64, **kw)
    rt = torch.as_tensor(r)
    got = _two_level(tw, rt, d, grid)
    want = tsw.windowed_rmatvec_plain(tw, rt, d)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", sorted(CASES))
def test_two_level_order_matches_jax(name):
    """The plan against the JAX package: its one-hot lowering at float64,
    its Pallas kernel in interpret mode at float32."""
    idx, val, d, r, kw = _case(name, dtype=np.float64)
    jw = jsw.build_column_windows(idx, val, d, **kw)
    onehot = np.asarray(jsw.rmatvec_windows_onehot(jw, jnp.asarray(r), d))
    tw = tsw.build_column_windows(idx, val, d, dtype=torch.float64, **kw)
    got = _two_level(tw, torch.as_tensor(r), d, 3).numpy()
    np.testing.assert_allclose(got, onehot, rtol=1e-12, atol=1e-12)

    idx, val, d, r, kw = _case(name)
    jw = jsw.build_column_windows(idx, val, d, **kw)
    pallas = np.asarray(jsw.rmatvec_windows_pallas(jw, jnp.asarray(r), d, interpret=True))
    tw = tsw.build_column_windows(idx, val, d, dtype=torch.float32, **kw)
    got = _two_level(tw, torch.as_tensor(r), d, 3).numpy()
    np.testing.assert_allclose(got, pallas, rtol=2e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_plain_on_card(dtype):
    """On the card: the CUDA kernel against the plain version computed in
    float64 from the same inputs, bit-identical across two runs. Bound per
    column: m·(u + 2⁻⁵³)·Σ|x| for m summed terms (any summation order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the chip: pytest -m cuda")
    dev = torch.device("cuda")
    f64 = torch.float64
    u = torch.finfo(dtype).eps / 2
    for name in LAYOUTS:
        idx, val, d, r, kw = _layout_inputs(name, dtype=np.float32)
        tw = tsw.build_column_windows(idx, val, d, dtype=dtype, device=dev, **kw)
        rt = torch.as_tensor(r, device=dev).to(dtype)
        before = tsw.windowed_rmatvec.launches
        got = tsw.windowed_rmatvec(tw, rt, d)
        again = tsw.windowed_rmatvec(tw, rt, d)
        torch.cuda.synchronize()
        assert tsw.windowed_rmatvec.launches == before + 2
        assert got.dtype == dtype
        assert torch.equal(got, again), name
        t64 = tw._replace(vals=tw.vals.to(f64))
        want = tsw.windowed_rmatvec_plain(t64, rt.to(f64), d)
        m = tsw.windowed_rmatvec_plain(
            t64._replace(vals=(tw.vals != 0).to(f64)), torch.ones_like(rt, dtype=f64), d
        )
        mag = tsw.windowed_rmatvec_plain(t64._replace(vals=t64.vals.abs()), rt.abs().to(f64), d)
        tol = 1.01 * m * (u + 2.0**-53) * mag
        assert ((got.to(f64) - want).abs() <= tol).all(), name
