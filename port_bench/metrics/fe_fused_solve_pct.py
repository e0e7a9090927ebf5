"""The share of the run's one-lane L-BFGS solves (the fixed effect's,
set-up included) that ran on the fused iteration kernels (``solo_head`` and
``solo_search`` in the port's ``csrc/lane_lbfgs.cu``), in %: the port's
``lbfgs.solo_fused`` over ``lbfgs.solo_fused + lbfgs.solo_plain``, counted
by ``GLMProblem.solve`` whether or not telemetry is on. None where the port
counts neither (a port without the fused iteration)."""

from port_bench.entries import registry


def read(name, ctx):
    fused = (registry.counters("lbfgs.solo_fused") or {}).get("lbfgs.solo_fused", 0)
    plain = (registry.counters("lbfgs.solo_plain") or {}).get("lbfgs.solo_plain", 0)
    total = fused + plain
    return 100.0 * fused / total if total else None
