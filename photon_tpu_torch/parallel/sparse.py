"""Multi-rank windowed sparse Xᵀr: instance-sharded reduction.

Counterpart of photon_tpu/parallel/sparse.py. The column-window layout
(ops/sparse_windows.py) is sharded on its instance axis: each rank owns
a contiguous run of instances, which are column-sorted, so a rank's
instances cover a contiguous range of column windows. The residual
vector ``per_row`` is whole on every rank (O(N) next to the O(N·K) slot
stream), each rank runs the SAME single-device Xᵀr (the CUDA kernel on
the card, its plain version on the CPU) over its instances into a full
[dim] partial that is zero outside its columns, and one ``all_reduce``
adds the partials. A window cut by a shard boundary is summed in two
partials, so the order of its sums differs from the unsharded kernel's.

Padding instances added for shard divisibility carry value 0, local
column w−1 and the last window id, which keeps the algebra and the
non-decreasing ``inst2win`` of the layout.
"""
from __future__ import annotations

import numpy as np
import torch

from photon_tpu_torch.ops.sparse_windows import ColumnWindows, windowed_rmatvec
from photon_tpu_torch.parallel.mesh import LocalMesh, Mesh, all_reduce_sum
from photon_tpu_torch.util.retry import RetryPolicy, is_transient, retry_call

#: placement retries of a window shard: the schedule of a random-effect
#: bucket's placement (game/coordinate.PLACEMENT_RETRY_POLICY)
PLACEMENT_RETRY_POLICY = RetryPolicy(attempts=3, base_s=20.0, multiplier=2.0, cap_s=120.0,
                                     jitter=0.1)


def pad_windows_for_mesh(
    windows: ColumnWindows, num_shards: int, num_features: int
) -> ColumnWindows:
    """Pad the instance axis to a multiple of ``num_shards`` with inert
    instances (vals 0, lcol w−1, last window id), on the host."""
    w_inst, _ = windows.rows.shape
    pad = (-w_inst) % num_shards
    if pad == 0:
        return windows
    w = windows.window
    num_windows = max(1, -(-num_features // w))

    def pad_leaf(x, fill):
        x = x.to("cpu")
        widths = [(0, pad)] + [(0, 0)] * (x.dim() - 1)
        return torch.as_tensor(np.pad(x.numpy(), widths, constant_values=fill))

    return ColumnWindows(
        rows=pad_leaf(windows.rows, 0),
        lcols=pad_leaf(windows.lcols, w - 1),
        vals=pad_leaf(windows.vals, 0),
        inst2win=pad_leaf(windows.inst2win, num_windows - 1),
        iota=windows.iota,
    )


def shard_range(w_inst: int, num_shards: int, shard: int) -> tuple[int, int]:
    """Instances [lo, hi) of shard ``shard`` of a padded layout."""
    per = w_inst // num_shards
    return shard * per, (shard + 1) * per


def shard_windows(windows: ColumnWindows, mesh: Mesh, num_features: int) -> ColumnWindows:
    """Pad the layout for the mesh and place this rank's instance range on
    its device. The placement runs inside ``retry_call(label=
    "device_put")`` with the fault point ``sparse.placement`` inside the
    retried thunk, as JAX's ``put_with_retry`` does; a failed attempt's
    tensors are dropped before the retry."""
    from photon_tpu_torch.util import faults

    windows = pad_windows_for_mesh(windows, mesh.size, num_features)
    lo, hi = shard_range(windows.rows.shape[0], mesh.size, mesh.rank)

    def place():
        faults.fault_point("sparse.placement")
        placed = []
        try:
            for name in ("rows", "lcols", "vals", "inst2win"):
                placed.append(getattr(windows, name)[lo:hi].contiguous().to(mesh.device))
            # phl-ok: PHL007 the window-local column offsets [w] are the same on every instance shard
            placed.append(windows.iota.to(mesh.device))
            return ColumnWindows(*placed)
        except BaseException:
            placed.clear()  # the retry must not hold this attempt's tensors
            raise

    return retry_call(place, policy=PLACEMENT_RETRY_POLICY, classify=is_transient,
                      label="device_put")


def sharded_windowed_rmatvec(
    windows: ColumnWindows, per_row: torch.Tensor, dim: int, mesh: Mesh | LocalMesh
) -> torch.Tensor:
    """Xᵀ·per_row over instance-sharded windows: this rank's Xᵀr over its
    instances (the kernel on the card) and one all_reduce of the disjoint
    column-range partials over every rank (off a mesh, the whole layout's
    Xᵀr). ``per_row`` is the whole [N] vector."""
    return all_reduce_sum(windowed_rmatvec(windows, per_row, dim), mesh)
