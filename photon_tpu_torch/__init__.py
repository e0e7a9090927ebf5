"""photon_tpu_torch: the PyTorch/CUDA port of photon_tpu.

The module tree mirrors ``photon_tpu`` so each counterpart is found under
the same name. The package imports torch and numpy only; host-side numpy
code it needs from the JAX package is carried as its own copy.

Entry points (``GameEstimator``, ``GameScorer``) take ``device=`` and
default to ``"cuda"``; without a card they raise unless the caller asks
for ``"cpu"``. Nothing falls back to the CPU on its own.
"""
