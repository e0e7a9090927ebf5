"""The share of the run's ELL forward passes X·v (set-up included) that
ran on the port's ELL kernel (``csrc/ell_matvec.cu``), in %: the port's
``ell.passes_fused`` over ``ell.passes_fused + ell.passes_plain``, counted
by ``ops.ell_matvec.ell_matvec`` whether or not telemetry is on. None
where the port counts neither (a port without the kernel)."""

from port_bench.entries import registry


def read(name, ctx):
    fused = (registry.counters("ell.passes_fused") or {}).get("ell.passes_fused", 0)
    plain = (registry.counters("ell.passes_plain") or {}).get("ell.passes_plain", 0)
    total = fused + plain
    return 100.0 * fused / total if total else None
