"""The share of the run's random-effect lanes that the fused lane kernel
(``csrc/lane_lbfgs.cu``) solved, in %: the port's ``re.lanes_fused`` over
``re.lanes_fused + re.lanes_plain`` (``entries/lanes.py``), over every
lane solve of the run, set-up included. None where the port counts
neither."""

from port_bench.entries import lanes


def read(name, ctx):
    counts = lanes.lane_counts()
    if counts is None:
        return None
    total = counts["fused"] + counts["plain"]
    return 100.0 * counts["fused"] / total if total else None
