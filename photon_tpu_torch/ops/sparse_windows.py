"""Column-windowed sparse layout and the windowed Xᵀr kernel.

Counterpart of photon_tpu/ops/sparse_windows.py. The layout is the same:
the ELL triples are sorted by column on the host, bucketed into windows
of ``window`` consecutive columns and padded to a common instance length
L; a window whose load exceeds L spills into several instances. Within an
instance the local columns are non-decreasing, and padding slots hold
(row 0, local column w−1, value 0).

The backward pass Xᵀr over that layout is the port of the TPU kernel
``rmatvec_windows_pallas`` (photon_tpu/ops/sparse_windows.py:418). On a
CUDA tensor :func:`windowed_rmatvec` launches the hand-written kernel in
``csrc/windowed_rmatvec.cu``; on a CPU tensor it runs
:func:`windowed_rmatvec_plain`, the same function in plain PyTorch. The
JAX module's prefix/onehot/flat lowerings work around XLA and collapse
into that one plain version.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch


class ColumnWindows(NamedTuple):
    """rows/lcols/vals: [W_inst, L]; inst2win: [W_inst] window id per
    instance (non-decreasing); iota: [w] = arange(window). W_inst is a
    multiple of 8 (inert padding instances), as the JAX build makes it.
    The JAX layout's ``bounds`` field feeds only its prefix-sum lowering,
    which has no counterpart here, so it is not built."""

    rows: torch.Tensor
    lcols: torch.Tensor
    vals: torch.Tensor
    inst2win: torch.Tensor
    iota: torch.Tensor

    @property
    def window(self) -> int:
        return self.iota.shape[0]

    @property
    def instance_len(self) -> int:
        return self.rows.shape[1]


def build_column_windows_numpy(
    indices: np.ndarray,
    values: np.ndarray,
    num_features: int,
    *,
    window: int = 128,
    instance_cap: int = 4096,
    chunk: int = 1024,
) -> dict[str, np.ndarray]:
    """Host build from padded-ELL [N, K] arrays — the numpy path of the JAX
    build (photon_tpu/ops/sparse_windows.py:196-254), array for array."""
    arr_idx = np.ascontiguousarray(np.asarray(indices), dtype=np.int32)
    arr_val = np.asarray(values)
    n, k = arr_idx.shape
    num_windows = max(1, -(-num_features // window))

    flat_col = arr_idx.reshape(-1).astype(np.int64)
    flat_val = arr_val.reshape(-1)
    flat_row = np.repeat(np.arange(n, dtype=np.int64), k)
    keep = flat_val != 0.0  # ELL padding slots carry value 0
    flat_col, flat_val, flat_row = flat_col[keep], flat_val[keep], flat_row[keep]
    nnz = flat_col.size
    counts = np.bincount(flat_col // window, minlength=num_windows)

    # the spill cap is rounded to the instance length so full spill
    # instances carry no padding (keeps lcols non-decreasing per instance)
    cap = int(min(counts.max() if nnz else 1, instance_cap))
    if cap > chunk:
        cap = -(-cap // chunk) * chunk
    else:
        cap = max(8, -(-cap // 8) * 8)
    length = cap
    n_inst = np.maximum(1, -(-counts // cap))
    w_inst = int(n_inst.sum())
    w_inst_pad = (-w_inst) % 8
    inst_base = np.concatenate([[0], np.cumsum(n_inst)])[:-1]
    win_start = np.concatenate([[0], np.cumsum(counts)])
    w_inst += w_inst_pad

    rows = np.zeros(w_inst * length, dtype=np.int32)
    lcols = np.full(w_inst * length, window - 1, dtype=np.int32)
    vals = np.zeros(w_inst * length, dtype=flat_val.dtype)
    order = np.argsort(flat_col, kind="stable")
    s_col, s_val, s_row = flat_col[order], flat_val[order], flat_row[order]
    s_win = s_col // window
    pos_in_win = np.arange(nnz, dtype=np.int64) - win_start[s_win]
    dest = (inst_base[s_win] + pos_in_win // cap) * length + (pos_in_win % cap)
    rows[dest] = s_row
    lcols[dest] = s_col % window
    vals[dest] = s_val

    inst2win = np.concatenate([
        np.repeat(np.arange(num_windows, dtype=np.int32), n_inst),
        np.full(w_inst_pad, num_windows - 1, dtype=np.int32),
    ])
    return {
        "rows": rows.reshape(w_inst, length),
        "lcols": lcols.reshape(w_inst, length),
        "vals": vals.reshape(w_inst, length),
        "inst2win": inst2win,
        "iota": np.arange(window, dtype=np.int32),
    }


def column_windows_from_numpy(
    arrays: dict, *, device="cpu", dtype=None
) -> ColumnWindows:
    """ColumnWindows of tensors from the numpy layout arrays (the output of
    :func:`build_column_windows_numpy`, or a JAX ``ColumnWindows`` turned
    to numpy field by field). Integer arrays stay int32; ``vals`` takes
    ``dtype`` when given."""
    def t(name, dt=None):
        # read-only arrays (e.g. views of JAX buffers) are copied first
        a = np.require(np.asarray(arrays[name]), requirements="W")
        return torch.as_tensor(a).to(device=device, dtype=dt)

    return ColumnWindows(
        rows=t("rows", torch.int32),
        lcols=t("lcols", torch.int32),
        vals=t("vals", dtype),
        inst2win=t("inst2win", torch.int32),
        iota=t("iota", torch.int32),
    )


def build_column_windows(
    indices: np.ndarray,
    values: np.ndarray,
    num_features: int,
    *,
    window: int = 128,
    instance_cap: int = 4096,
    chunk: int = 1024,
    device="cpu",
    dtype=None,
) -> ColumnWindows:
    """Host build, placed on ``device`` (vals in ``dtype`` when given)."""
    return column_windows_from_numpy(
        build_column_windows_numpy(
            indices, values, num_features,
            window=window, instance_cap=instance_cap, chunk=chunk,
        ),
        device=device,
        dtype=dtype,
    )


def maybe_build_windows(
    indices: np.ndarray,
    values: np.ndarray,
    num_features: int,
    *,
    device: torch.device,
    dtype=None,
    force: bool = False,
    window: int = 128,
    instance_cap: int = 4096,
) -> ColumnWindows | None:
    """Layout policy: windows on a CUDA device at d ≥ 1024, and on any
    device when ``force`` is set (the CPU tests run the plain Xᵀr so)."""
    device = torch.device(device)
    if force or (device.type == "cuda" and num_features >= 1024):
        return build_column_windows(
            indices, values, num_features,
            window=window, instance_cap=instance_cap,
            device=device, dtype=dtype,
        )
    return None


# ---------------------------------------------------------------------------
# Xᵀr over the layout: the plain version and the CUDA kernel's wrapper
# ---------------------------------------------------------------------------


def windowed_rmatvec_plain(
    windows: ColumnWindows, per_row: torch.Tensor, dim: int
) -> torch.Tensor:
    """out[c] = Σ vals·r[rows] over the slots whose global column is c —
    the plain PyTorch version of the kernel (CPU tests, and the reference
    the kernel is held against on the card)."""
    w = windows.window
    num_windows = max(1, -(-dim // w))
    gcols = (windows.inst2win.long()[:, None] * w + windows.lcols.long()).reshape(-1)
    contrib = (windows.vals * per_row[windows.rows.long()]).reshape(-1)
    out = torch.zeros(num_windows * w, dtype=contrib.dtype, device=contrib.device)
    out.index_add_(0, gcols, contrib)
    return out[:dim]


#: threads per CTA (at most) and consecutive slots per thread of the
#: kernel (kMaxThreads, kItems in csrc/windowed_rmatvec.cu)
KERNEL_THREADS, KERNEL_ITEMS = 256, 8


def kernel_tile(length: int) -> int:
    """Slots in one of the kernel's tiles: its CTA's threads × 8, with
    min(256, L/8 rounded up to a warp) threads. An instance of L slots is
    ⌈L / tile⌉ tiles, the last one ragged."""
    return min(KERNEL_THREADS, -(-length // (KERNEL_ITEMS * 32)) * 32) * KERNEL_ITEMS


def tile_windows(inst2win: np.ndarray, length: int) -> np.ndarray:
    """Window id of each tile the kernel walks, in order."""
    return np.repeat(np.asarray(inst2win), -(-length // kernel_tile(length)))


def work_partition(n_tiles: int, grid: int) -> np.ndarray:
    """Tile ranges of the kernel's persistent grid: CTA b takes the tiles
    [bounds[b], bounds[b+1]). The grid is capped at n_tiles, so no range is
    empty; the kernel computes the same bounds on the card (``range_lo``
    in csrc/windowed_rmatvec.cu)."""
    grid = min(grid, n_tiles)
    return np.arange(grid + 1, dtype=np.int64) * n_tiles // grid


def fixup_plan(tile_win: np.ndarray, bounds: np.ndarray) -> tuple[np.ndarray, dict]:
    """Where the kernel's per-(CTA, window) sums go, as the kernel decides
    it on the card from the window of each tile (:func:`tile_windows`). A
    window whose tiles all lie in one CTA's range is written straight to
    the output. A window split across CTAs leaves one partial per CTA in
    scratch[b, slot] — slot 0 for a CTA's first window, 1 for its last —
    and the fix-up sums them in CTA order.

    Returns ``dest`` ([grid, 2] window id of scratch[b, slot], -1 unused)
    and ``split`` {window: [(b, slot), ...] in CTA order}."""
    tile_win = np.asarray(tile_win)
    n_tiles, grid = len(tile_win), len(bounds) - 1
    dest = np.full((grid, 2), -1, dtype=np.int64)
    split: dict[int, list[tuple[int, int]]] = {}
    for b in range(grid):
        lo, hi = int(bounds[b]), int(bounds[b + 1])
        first, last = int(tile_win[lo]), int(tile_win[hi - 1])
        cont_before = lo > 0 and tile_win[lo - 1] == first
        cont_after = hi < n_tiles and tile_win[hi] == last
        if cont_before or (first == last and cont_after):
            dest[b, 0] = first
            split.setdefault(first, []).append((b, 0))
        if last != first and cont_after:
            dest[b, 1] = last
            split.setdefault(last, []).append((b, 1))
    return dest, split


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"windowed_rmatvec: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"windowed_rmatvec: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}"
        )
    if t.device != device:
        raise ValueError(f"windowed_rmatvec: {name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"windowed_rmatvec: {name} must be contiguous")


#: widest window the kernel's shared-memory accumulator takes
MAX_KERNEL_WINDOW = 8192
#: value types the kernel takes (it sums in the same type)
KERNEL_DTYPES = (torch.float32, torch.float64)
#: what :func:`windowed_rmatvec_probe` leaves of the kernel's work
PROBE_MODES = {"stream": 1, "stream_gather": 2, "gather": 3}


def _kernel_lib():
    from photon_tpu_torch.ops import cuda_build

    lib = cuda_build.load("windowed_rmatvec")
    if lib.windowed_rmatvec.argtypes is None:
        # without argtypes ctypes would pass each pointer as a 32-bit int
        ll, ptr = ctypes.c_longlong, ctypes.c_void_p
        lib.windowed_rmatvec_grid.restype = ctypes.c_int
        lib.windowed_rmatvec_grid.argtypes = [
            ctypes.c_int, ll, ll, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ]
        lib.windowed_rmatvec.restype = ctypes.c_int
        lib.windowed_rmatvec.argtypes = [ctypes.c_int] + [ptr] * 7 + [
            ll, ll, ctypes.c_int, ll, ctypes.c_int, ptr,
        ]
        lib.windowed_rmatvec_probe.restype = ctypes.c_int
        lib.windowed_rmatvec_probe.argtypes = [ctypes.c_int, ctypes.c_int] + [ptr] * 7 + [
            ll, ll, ctypes.c_int, ll, ll, ctypes.c_int, ptr,
        ]
    return lib


def _launch(windows: ColumnWindows, per_row: torch.Tensor, dim: int, probe: int = 0):
    if per_row.dtype not in KERNEL_DTYPES:
        raise TypeError(
            f"windowed_rmatvec: per_row must be float32 or float64, got {per_row.dtype}"
        )
    w_inst, length = windows.rows.shape
    w = windows.window
    if w > MAX_KERNEL_WINDOW:
        raise ValueError(f"windowed_rmatvec: window {w} > {MAX_KERNEL_WINDOW}")
    if w_inst == 0 or length == 0:
        raise ValueError("windowed_rmatvec: empty layout")
    if length % 4:
        # the bulk copies move whole 16-byte groups; the build keeps L a
        # multiple of 8 unless ``chunk`` is not
        raise ValueError(f"windowed_rmatvec: instance length {length} is not a multiple of 4")
    if per_row.dim() != 1:
        raise ValueError("windowed_rmatvec: per_row must be 1-D")
    dev = per_row.device
    if dev.type != "cuda":
        raise ValueError(f"windowed_rmatvec_cuda needs CUDA tensors, got {dev}")
    dtype = per_row.dtype
    _check("per_row", per_row, dtype, per_row.shape, dev)
    _check("rows", windows.rows, torch.int32, (w_inst, length), dev)
    _check("lcols", windows.lcols, torch.int32, (w_inst, length), dev)
    _check("vals", windows.vals, dtype, (w_inst, length), dev)
    _check("inst2win", windows.inst2win, torch.int32, (w_inst,), dev)
    if any(t.data_ptr() % 16 for t in (windows.rows, windows.lcols, windows.vals)):
        raise ValueError("windowed_rmatvec: rows, lcols and vals must be 16-byte aligned")
    f64 = int(dtype == torch.float64)
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        g = ctypes.c_int(0)
        rc = lib.windowed_rmatvec_grid(f64, w_inst, length, w, ctypes.byref(g))
        if rc != 0:
            raise RuntimeError(f"windowed_rmatvec: occupancy query failed: cudaError {rc}")
        grid = g.value
        scratch = torch.empty((grid, 2, w), dtype=dtype, device=dev)
        out = torch.empty((dim,), dtype=dtype, device=dev)
        ptrs = (
            windows.rows.data_ptr(), windows.lcols.data_ptr(), windows.vals.data_ptr(),
            windows.inst2win.data_ptr(), per_row.data_ptr(), scratch.data_ptr(),
            out.data_ptr(),
        )
        stream = torch.cuda.current_stream(dev).cuda_stream
        if probe:
            rc = lib.windowed_rmatvec_probe(
                probe, f64, *ptrs, w_inst, length, w, dim, per_row.shape[0], grid, stream
            )
        else:
            rc = lib.windowed_rmatvec(f64, *ptrs, w_inst, length, w, dim, grid, stream)
    if rc != 0:
        raise RuntimeError(f"windowed_rmatvec kernel launch failed: cudaError {rc}")
    return out


def windowed_rmatvec_cuda(
    windows: ColumnWindows, per_row: torch.Tensor, dim: int
) -> torch.Tensor:
    """Launch the CUDA kernel (per-window partials over a persistent grid,
    then the fix-up of windows split across CTAs) on the current stream.
    float32 or float64; anything the kernel cannot take raises."""
    out = _launch(windows, per_row, dim)
    windowed_rmatvec.launches += 1
    return out


def windowed_rmatvec_probe(
    windows: ColumnWindows, per_row: torch.Tensor, dim: int, mode: str
) -> None:
    """The kernel with part of its work left out, to time on the card what
    bounds it (``mode`` in :data:`PROBE_MODES`: the triple stream alone;
    the stream and the r[rows] reads without the scan; r read at uniformly
    random rows alone). It computes nothing useful and is not counted in
    ``windowed_rmatvec.launches``."""
    _launch(windows, per_row, dim, probe=PROBE_MODES[mode])


def windowed_rmatvec(
    windows: ColumnWindows, per_row: torch.Tensor, dim: int
) -> torch.Tensor:
    """Xᵀ·per_row over the window layout → [dim]. A CPU tensor runs the
    plain version; a CUDA tensor launches the kernel (or raises)."""
    if per_row.device.type == "cpu":
        return windowed_rmatvec_plain(windows, per_row, dim)
    return windowed_rmatvec_cuda(windows, per_row, dim)


#: kernel launches through the wrapper (one per call: the partials kernel
#: and its fix-up)
windowed_rmatvec.launches = 0
