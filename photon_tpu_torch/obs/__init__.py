"""Training health (``obs.health``): the divergence monitor of the
descent loop. Counterpart of the health module of photon_tpu/obs; the
rest of that package (spans, metrics, the flight recorder) is not
ported yet."""
