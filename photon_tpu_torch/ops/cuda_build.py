"""Build and load the hand-written CUDA kernels of ``photon_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into ``build/photon_tpu_torch/lib<name>-<hash>.so`` at first use,
then loaded with ctypes. The hash covers the source and the flags, so an
edited kernel rebuilds and an unchanged one is reused. Nothing is built or
loaded when a module is imported: the first launch on a CUDA tensor does it.
Each library's C signatures are declared here (:data:`SIGNATURES`), as
are the check of a tensor handed to a kernel, the launch counts and the
record of each dispatch rule's choice between a kernel and its plain
version (:func:`record_route`).
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from photon_tpu_torch import obs
from photon_tpu_torch.util import compile_watch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "photon_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_I, _LL, _PTR, _DBL = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_double
#: each library's C entry points, name → (restype, argtypes), set on the
#: library at load: without argtypes ctypes would pass each pointer as a
#: 32-bit int
SIGNATURES = {
    "windowed_rmatvec": {
        "windowed_rmatvec_grid": (_I, [_I, _LL, _LL, _I, ctypes.POINTER(_I)]),
        "windowed_rmatvec": (_I, [_I] + [_PTR] * 7 + [_LL, _LL, _I, _LL, _I, _PTR]),
        "windowed_rmatvec_probe": (_I, [_I, _I] + [_PTR] * 7 + [_LL, _LL, _I, _LL, _LL, _I, _PTR]),
    },
    "lane_lbfgs": {
        "lane_lbfgs": (_I, [_I] + [_PTR] * 15 + [_LL] + [_I] * 6 + [_DBL] * 4 + [_PTR]),
        "solo_head": (_I, [_I] + [_PTR] * 15 + [_LL] + [_I] * 3 + [_DBL, _PTR]),
        "solo_search_grid": (_I, [_I, _LL]),
        "solo_search": (_I, [_I] + [_PTR] * 6 + [_I, _PTR, _PTR, _LL, _I, _I] + [_DBL] * 3
                        + [_PTR]),
    },
    "ell_matvec": {
        "ell_matvec": (_I, [_I] * 4 + [_PTR] * 4 + [_LL, _I, _PTR]),
    },
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
#: name → seconds the last nvcc build took (0.0 when the library was reused)
build_seconds: dict[str, float] = {}
#: launches of each kernel entry since the process started, counted where
#: each is issued (a probe's launches are not); never reset, so every
#: reader takes a difference
_launches = dict.fromkeys(
    ("windowed_rmatvec", "lane_lbfgs", "solo_head", "solo_search", "ell_matvec"), 0)
_launches_lock = threading.Lock()


#: the registry tallies of each kind of routed work: (fused, plain)
ROUTE_TALLIES = {"lanes": ("re.lanes_fused", "re.lanes_plain"),
                 "solo": ("lbfgs.solo_fused", "lbfgs.solo_plain"),
                 "ell": ("ell.passes_fused", "ell.passes_plain")}
#: every routed solve or pass since the process started, by (kind, device
#: type, route), the route "fused" or the plain version's reason; a lane
#: batch counts its lanes. ``obs.reset()`` leaves it: readers take
#: differences
routes: collections.Counter = collections.Counter()
_routes_lock = threading.Lock()


def record_route(kind: str, device_type: str, reason: str | None, n: int = 1) -> bool:
    """Record ``n`` units of ``kind`` ("lanes": lanes of one batch; "solo":
    a one-lane solve; "ell": an ELL forward pass) on ``device_type`` by
    their route (``reason``: the dispatch rule's answer, None for the
    kernel) in :data:`routes` and as the kind's registry tally, telemetry
    on or off. Returns whether the route is the kernel."""
    fused = reason is None
    obs.tally(ROUTE_TALLIES[kind][0 if fused else 1], n)
    with _routes_lock:
        routes[(kind, device_type, "fused" if fused else reason)] += n
    return fused


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists."""
    out = library_path(name)
    if out.is_file():
        build_seconds.setdefault(name, 0.0)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name}.cu (rc={proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    build_seconds[name] = time.perf_counter() - t0
    compile_watch.record_native_build(name, build_seconds[name])
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for entry, (restype, argtypes) in SIGNATURES[name].items():
                fn = getattr(lib, entry)
                fn.restype, fn.argtypes = restype, argtypes
            _loaded[name] = lib
        return lib


def count_launch(entry: str) -> None:
    """One launch of the kernel entry ``entry`` issued."""
    with _launches_lock:
        _launches[entry] += 1


def launch_count(*entries: str) -> int:
    """The launches of ``entries`` since the process started, summed."""
    return sum(_launches[e] for e in entries)


def check_tensor(kernel: str, name: str, t, dtype, shape, device) -> None:
    """Raise unless ``t`` (argument ``name`` of ``kernel``) has ``dtype``
    (TypeError), ``shape`` and ``device`` and is contiguous (ValueError)."""
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")
