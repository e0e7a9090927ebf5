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
import time
from typing import NamedTuple

import numpy as np
import torch

from photon_tpu_torch import obs
from photon_tpu_torch.ops import cuda_build


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


#: how the last host build of a layout ran: ``path`` "native" (the
#: counting sort of native/window_builder.cpp) or "numpy" (an argsort),
#: ``reason`` why it took numpy (None when native), ``seconds`` its wall,
#: and ``phases`` that wall split in order: ``library`` (finding and
#: binding the native library), ``inputs`` (the contiguous int32 and
#: float32 copies), ``histogram`` (the per-window counts), ``alloc`` (the
#: output arrays; ``np.zeros`` maps pages that the fill first touches),
#: ``fill`` (the sort into place) and ``finish`` (``inst2win``)
last_build: dict = {"path": None, "reason": None, "seconds": None, "phases": None}


def _native_window_lib(arr_idx: np.ndarray, arr_val: np.ndarray):
    """(library, None) when the native build applies, else (None, why).
    It takes float32 values only, as in the JAX package: a float64
    layout keeps the numpy path, so both packages give the same arrays at
    both dtypes."""
    if arr_val.dtype != np.float32:
        return None, f"values are {arr_val.dtype}; the native build takes float32"
    if arr_idx.size == 0:
        return None, "no slots to sort"
    from photon_tpu_torch.data import native_index

    lib = native_index.load_native_lib()
    if lib is None:
        return None, native_index.native_unavailable_reason
    if lib.win_fill.argtypes is None:
        # without argtypes ctypes would pass each pointer as a 32-bit int
        ll, ptr = ctypes.c_int64, ctypes.c_void_p
        lib.win_col_histogram.restype = ll
        lib.win_col_histogram.argtypes = [ptr, ptr, ll, ll, ptr]
        lib.win_fill.restype = ll
        lib.win_fill.argtypes = [ptr, ptr, ll, ll, ll, ll, ll, ll, ptr, ptr, ptr, ptr, ptr, ptr]
    return lib, None


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def build_column_windows_numpy(
    indices: np.ndarray,
    values: np.ndarray,
    num_features: int,
    *,
    window: int = 128,
    instance_cap: int = 4096,
    chunk: int = 1024,
    native: bool = True,
) -> dict[str, np.ndarray]:
    """Host build from padded-ELL [N, K] arrays, array for array the JAX
    build (photon_tpu/ops/sparse_windows.py:196-254). float32 values take
    the native counting sort by column (O(nnz + d), the JAX package's
    ``_native_histogram`` / ``_native_fill``); other values, a missing
    library, or ``native=False`` take numpy's stable argsort. Both give
    the same arrays. ``last_build`` records which ran and why. Each build
    adds its stored nonzeros, its slots (W_inst·L) and its instances to
    the registry counters ``windows.nnz``, ``windows.slots`` and
    ``windows.instances`` (``obs.tally``: counted whether or not
    telemetry is on)."""
    t0 = time.perf_counter()
    phases, marks = {}, [t0]

    def mark(name):
        marks.append(time.perf_counter())
        phases[name] = marks[-1] - marks[-2]

    in_idx, arr_val = np.asarray(indices), np.asarray(values)
    if arr_val.shape != in_idx.shape:
        raise ValueError(f"values {arr_val.shape} and indices {in_idx.shape} differ in shape")
    n, k = in_idx.shape
    num_windows = max(1, -(-num_features // window))

    lib, reason = (
        _native_window_lib(in_idx, arr_val) if native else (None, "numpy build asked for")
    )
    mark("library")
    arr_idx = np.ascontiguousarray(in_idx, dtype=np.int32)
    if lib is not None:
        nat_vals = np.ascontiguousarray(arr_val, dtype=np.float32)
    mark("inputs")
    if lib is not None:
        col_counts = np.zeros(num_features, dtype=np.int64)
        nnz = int(lib.win_col_histogram(
            _ptr(arr_idx), _ptr(nat_vals), arr_idx.size, num_features, _ptr(col_counts)
        ))
        if nnz < 0:
            raise ValueError("sparse column index outside [0, num_features)")
        counts = np.add.reduceat(
            np.pad(col_counts, (0, num_windows * window - num_features)),
            np.arange(num_windows) * window,
        )
    else:
        flat_col = arr_idx.reshape(-1).astype(np.int64)
        flat_val = arr_val.reshape(-1)
        flat_row = np.repeat(np.arange(n, dtype=np.int64), k)
        keep = flat_val != 0.0  # ELL padding slots carry value 0
        flat_col, flat_val, flat_row = flat_col[keep], flat_val[keep], flat_row[keep]
        nnz = flat_col.size
        counts = np.bincount(flat_col // window, minlength=num_windows)
    mark("histogram")

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
    vals = np.zeros(w_inst * length, dtype=np.float32 if lib is not None else flat_val.dtype)
    mark("alloc")
    if lib is not None:
        if nnz > 0:  # an all-padding layout needs no fill pass
            col_next = np.concatenate([[0], np.cumsum(col_counts)])[:-1].astype(np.int64)
            win_start64 = np.ascontiguousarray(win_start, dtype=np.int64)
            inst_base64 = np.ascontiguousarray(inst_base, dtype=np.int64)
            rc = int(lib.win_fill(
                _ptr(arr_idx), _ptr(nat_vals), arr_idx.size, k, num_features, window, cap,
                length, _ptr(col_next), _ptr(win_start64), _ptr(inst_base64),
                _ptr(rows), _ptr(lcols), _ptr(vals),
            ))
            if rc != 0:
                raise ValueError(f"native window fill failed rc={rc}")
    else:
        order = np.argsort(flat_col, kind="stable")
        s_col, s_val, s_row = flat_col[order], flat_val[order], flat_row[order]
        s_win = s_col // window
        pos_in_win = np.arange(nnz, dtype=np.int64) - win_start[s_win]
        dest = (inst_base[s_win] + pos_in_win // cap) * length + (pos_in_win % cap)
        rows[dest] = s_row
        lcols[dest] = s_col % window
        vals[dest] = s_val
    mark("fill")

    inst2win = np.concatenate([
        np.repeat(np.arange(num_windows, dtype=np.int32), n_inst),
        np.full(w_inst_pad, num_windows - 1, dtype=np.int32),
    ])
    mark("finish")
    obs.tally("windows.nnz", nnz)
    obs.tally("windows.slots", w_inst * length)
    obs.tally("windows.instances", w_inst)
    last_build.update(
        path="numpy" if lib is None else "native",
        reason=reason,
        seconds=marks[-1] - t0,
        phases=phases,
    )
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


def windows_wanted(device, num_features: int) -> bool:
    """Whether a sparse batch on ``device`` gets the window layout: on a
    CUDA device at d ≥ 1024."""
    return torch.device(device).type == "cuda" and num_features >= 1024


def maybe_window_layout(
    indices: np.ndarray,
    values: np.ndarray,
    num_features: int,
    *,
    device: torch.device,
    force: bool = False,
    window: int = 128,
    instance_cap: int = 4096,
) -> dict | None:
    """Layout policy: the layout's numpy arrays
    (:func:`build_column_windows_numpy`) where :func:`windows_wanted` says,
    and on any device when ``force`` is set (the CPU tests run the plain
    Xᵀr so), else None; nothing is placed."""
    if force or windows_wanted(torch.device(device), num_features):
        return build_column_windows_numpy(
            indices, values, num_features, window=window, instance_cap=instance_cap,
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


#: widest window the kernel's shared-memory accumulator takes
MAX_KERNEL_WINDOW = 8192
#: value types the kernel takes (it sums in the same type)
KERNEL_DTYPES = (torch.float32, torch.float64)
#: what :func:`windowed_rmatvec_probe` leaves of the kernel's work
PROBE_MODES = {"stream": 1, "stream_gather": 2, "gather": 3}


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
    check = cuda_build.check_tensor
    check("windowed_rmatvec", "per_row", per_row, dtype, per_row.shape, dev)
    check("windowed_rmatvec", "rows", windows.rows, torch.int32, (w_inst, length), dev)
    check("windowed_rmatvec", "lcols", windows.lcols, torch.int32, (w_inst, length), dev)
    check("windowed_rmatvec", "vals", windows.vals, dtype, (w_inst, length), dev)
    check("windowed_rmatvec", "inst2win", windows.inst2win, torch.int32, (w_inst,), dev)
    if any(t.data_ptr() % 16 for t in (windows.rows, windows.lcols, windows.vals)):
        raise ValueError("windowed_rmatvec: rows, lcols and vals must be 16-byte aligned")
    f64 = int(dtype == torch.float64)
    lib = cuda_build.load("windowed_rmatvec")
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
    cuda_build.count_launch("windowed_rmatvec")
    return out


def windowed_rmatvec_probe(
    windows: ColumnWindows, per_row: torch.Tensor, dim: int, mode: str
) -> None:
    """The kernel with part of its work left out, to time on the card what
    bounds it (``mode`` in :data:`PROBE_MODES`: the triple stream alone;
    the stream and the r[rows] reads without the scan; r read at uniformly
    random rows alone). It computes nothing useful and is not counted among
    the kernel's launches (``cuda_build.launch_count``)."""
    _launch(windows, per_row, dim, probe=PROBE_MODES[mode])


def windowed_rmatvec(
    windows: ColumnWindows, per_row: torch.Tensor, dim: int
) -> torch.Tensor:
    """Xᵀ·per_row over the window layout → [dim]. A CPU tensor runs the
    plain version; a CUDA tensor launches the kernel (or raises)."""
    if per_row.device.type == "cpu":
        return windowed_rmatvec_plain(windows, per_row, dim)
    return windowed_rmatvec_cuda(windows, per_row, dim)
