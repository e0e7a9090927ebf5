"""The sparse ELL forward pass X·v: the plain version, the CUDA kernel's
wrapper, and the rule that chooses between them.

``csrc/ell_matvec.cu`` gathers v[indices], multiplies by the values and
sums each row in one launch, writing z [N] and nothing else. The plain
version is the gather and row sum of PyTorch ops that JAX's
``photon_tpu/ops/objective.py`` writes as an XLA gather; the CPU runs it,
and the card tests hold the kernel to it. :func:`plain_reason` is the
dispatch rule that :func:`ell_matvec` asks once a pass: the kernel takes a
pass exactly when it returns None, and then :func:`ell_matvec_cuda`
launches or raises. Every pass is recorded by its route
(``cuda_build.record_route``, kind "ell"), which bumps the
registry tallies ``ell.passes_fused`` and ``ell.passes_plain`` telemetry on
or off; the kernel's launches are ``cuda_build.launch_count("ell_matvec")``.
"""
from __future__ import annotations

import torch

from photon_tpu_torch.ops import cuda_build
from photon_tpu_torch.ops.gather import take_1d

#: v's types the kernel takes (it sums in v's type)
KERNEL_DTYPES = (torch.float32, torch.float64)
#: the values' types the kernel takes, by the kernel's code for each
VALUE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
#: most lanes the kernel gives a row (one warp)
MAX_GROUP = 32


def ell_matvec_plain(indices: torch.Tensor, values: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Σⱼ values[..., j]·v[indices[..., j]]: the gather and the row sum,
    the values widened to v's type as JAX's promotion does."""
    return (take_1d(v, indices) * values.to(v.dtype)).sum(-1)


def launch_shape(k: int, aligned: bool = True) -> tuple[int, int]:
    """(slots a chunk, lanes a row) of the kernel for rows of ``k`` slots:
    chunks of 4 slots (16-byte index loads) when ``k`` is a multiple of 4
    and the blocks are ``aligned`` to 16 bytes, else of 1; the largest
    power of two lanes, at most :data:`MAX_GROUP`, that has a chunk for
    every lane."""
    vw = 4 if aligned and k % 4 == 0 else 1
    chunks = k // vw
    group = 1
    while group * 2 <= min(chunks, MAX_GROUP):
        group *= 2
    return vw, group


def plain_reason(indices: torch.Tensor, values: torch.Tensor, v: torch.Tensor) -> str | None:
    """Why an ELL pass keeps the plain version, or None when the kernel
    takes it: v 1-D, contiguous, float32 or float64; indices [N, K] int32
    and values [N, K] float32, float64 or bfloat16, both contiguous, with N
    and K at least 1; on a CUDA device."""
    if v.dim() != 1:
        return f"v of {v.dim()} dims (lanes)"
    if v.dtype not in KERNEL_DTYPES:
        return f"v {v.dtype}"
    if indices.dtype != torch.int32:
        return f"indices {indices.dtype}"
    if values.dtype not in VALUE_CODES:
        return f"values {values.dtype}"
    if indices.dim() != 2 or values.shape != indices.shape:
        return "indices and values not one [N, K] block"
    if not (v.is_contiguous() and indices.is_contiguous() and values.is_contiguous()):
        return "not contiguous"
    if indices.numel() == 0:
        return "empty block"
    if v.device.type != "cuda":
        return f"on {v.device.type}"
    return None


def ell_matvec_cuda(indices: torch.Tensor, values: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream → z [N] in v's type. Raises
    on what the kernel does not take (see :func:`plain_reason`)."""
    dev = v.device
    if dev.type != "cuda":
        raise ValueError(f"ell_matvec_cuda needs CUDA tensors, got {dev}")
    if v.dim() != 1 or indices.dim() != 2:
        raise ValueError(f"ell_matvec: v must be 1-D and indices [N, K], got {tuple(v.shape)} "
                         f"and {tuple(indices.shape)}")
    if v.dtype not in KERNEL_DTYPES:
        raise TypeError(f"ell_matvec: v must be float32 or float64, got {v.dtype}")
    if values.dtype not in VALUE_CODES:
        raise TypeError(f"ell_matvec: values must be float32, float64 or bfloat16, "
                        f"got {values.dtype}")
    n, k = indices.shape
    if n == 0 or k == 0:
        raise ValueError("ell_matvec: empty block")
    check = cuda_build.check_tensor
    check("ell_matvec", "v", v, v.dtype, v.shape, dev)
    check("ell_matvec", "indices", indices, torch.int32, (n, k), dev)
    check("ell_matvec", "values", values, values.dtype, (n, k), dev)
    aligned = indices.data_ptr() % 16 == 0 and values.data_ptr() % 16 == 0
    vw, group = launch_shape(k, aligned)
    out = torch.empty((n,), dtype=v.dtype, device=dev)
    lib = cuda_build.load("ell_matvec")
    with torch.cuda.device(dev):
        rc = lib.ell_matvec(
            int(v.dtype == torch.float64), VALUE_CODES[values.dtype], vw, group.bit_length() - 1,
            indices.data_ptr(), values.data_ptr(), v.data_ptr(), out.data_ptr(), n, k,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"ell_matvec kernel launch failed: cudaError {rc}")
    cuda_build.count_launch("ell_matvec")
    return out


def ell_matvec(indices: torch.Tensor, values: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """X·v over a padded ELL block (padding slots hold value 0): the kernel
    where :func:`plain_reason` finds nothing against it, else the plain
    version; the pass recorded by its route."""
    if cuda_build.record_route("ell", v.device.type, plain_reason(indices, values, v)):
        return ell_matvec_cuda(indices, values, v)
    return ell_matvec_plain(indices, values, v)
