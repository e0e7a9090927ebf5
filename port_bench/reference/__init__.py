"""The plain reference that decides ``correct``: the published algorithms
(Photon-ML's GLM objectives, L-BFGS with a strong-Wolfe line search,
GAME coordinate descent) in plain PyTorch, lane-batched where the
random effects need it. It imports nothing of the port, recomputes every
layout the port derives from the inputs (entity grouping, the reservoir
choice of active rows), and runs in the type it is given: float64 for the
reference, bfloat16 for the control."""
