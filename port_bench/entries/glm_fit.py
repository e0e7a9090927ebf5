"""Repeated cold single-GLM fits: what a Photon-ML user waits for at each
λ point of a sparse logistic model with an elastic net.

Set-up makes the data from the configuration's data seed, its rows
permuted by the run's seed, and places it as ``train_glm_grid`` places a
sparse ``DataSet`` (``to_device_sparse_batch``: the ELL block and the
column-window layout, on the card; ``choose_sparse`` picks that layout at
the configuration's shape), then runs one fit. A step is one more
call of ``train_glm_grid`` on that placed batch, as the driver reuses it
across λ points: one λ, from a cold start, OWL-QN with the configuration's
iteration cap and tolerance, ending with the read-back of the final
objective.

The judge fits the same data with the plain reference in float64
(``reference/owlqn.py``) and compares every step's objective along the
first iterations, the last step's reported objective and its margins
against the reference's at the last step's coefficients, and how far those
coefficients' objective lies above the reference's own at the cap. Like
``game_fit``, this file imports the port.
"""
from __future__ import annotations

import numpy as np
import torch

from port_bench.counts import glm as glm_counts
from port_bench.counts import work
from port_bench.gen.kdd2010 import kdd2010_arrays
from port_bench.reference import compare, owlqn

#: the iterations, from the start, whose objective the judge compares
PATH_ITERATIONS = 4


class Cell:
    def __init__(self, config: dict, mix: dict, *, seed: int, device):
        self.config, self.mix, self.seed = config, mix, seed
        self.device = torch.device(device)
        self.fit_spec = config["fit"]
        #: the configuration's type (the tests run the program at float64 too)
        self.dtype = getattr(torch, config["dtype"])
        self.values: list[float] = []
        #: each step's objective after every iteration (device tensors,
        #: read once the window has closed)
        self.paths: list = []
        self.last = None
        self.batch = None
        self.build_stages: dict | None = None

    # --- the program -------------------------------------------------------
    def _problem_config(self):
        from photon_tpu_torch.optimize.common import OptimizerConfig
        from photon_tpu_torch.optimize.problem import (
            GLMProblemConfig,
            RegularizationContext,
            RegularizationType,
        )
        from photon_tpu_torch.types import OptimizerType, TaskType

        f = self.fit_spec
        return GLMProblemConfig(
            task=TaskType.LOGISTIC_REGRESSION,
            optimizer=OptimizerType.OWLQN,
            optimizer_config=OptimizerConfig(
                max_iterations=f["max_iterations"], tolerance=f["tolerance"],
                num_corrections=f["history"], ls_max_iterations=f["line_search_trials"]),
            regularization=RegularizationContext(RegularizationType.ELASTIC_NET,
                                                 f["elastic_net_alpha"]),
        )

    def setup(self) -> None:
        from photon_tpu_torch import obs
        from photon_tpu_torch.data.dataset import DataSet, to_device_sparse_batch

        d = {k: v for k, v in self.config["data"].items() if k not in ("generator", "seed")}
        self.arrays = kdd2010_arrays(self.config["data"]["seed"], permutation_seed=self.seed,
                                     device=self.device, **d)
        a = self.arrays
        n = len(a["labels"])
        data = DataSet(indptr=a["indptr"], indices=a["indices"], values=a["values"],
                       labels=a["labels"], offsets=np.zeros(n), weights=np.ones(n),
                       num_features=a["columns"])
        self.problem_config = self._problem_config()
        with obs.stage_walls() as walls:
            # the window layout is what the card's policy builds at this
            # width; asking for it also gives the CPU's runs the layout
            self.batch = to_device_sparse_batch(data, dtype=self.dtype, device=self.device,
                                                column_windows=True)
        self.build_stages = walls
        self._fit()

    def _fit(self):
        from photon_tpu_torch.model_training import train_glm_grid

        (model,) = train_glm_grid(self.batch, self.problem_config, [self.fit_spec["lambda"]],
                                  warm_start=False, num_features=self.arrays["columns"],
                                  device=self.device)
        return model

    def step(self, per_coordinate: bool = False) -> None:
        model = self._fit()
        self.values.append(float(model.result.value))  # the read-back
        self.paths.append(model.result.loss_history)
        self.last = model

    # --- what the metric readers read --------------------------------------
    def _shape(self) -> tuple[int, int, int]:
        """(nonzeros, rows, columns) of the data set."""
        a = self.arrays
        return int(a["indptr"][-1]), len(a["labels"]), a["columns"]

    def step_work(self) -> tuple[float, float]:
        """(operations, bytes) of one step, from the last step's counters:
        the steps repeat one computation."""
        r = self.last.result
        return glm_counts.fit_work(*self._shape(), passes=int(r.n_feature_passes),
                                   iterations=int(r.iterations), m=self.fit_spec["history"])

    def kernel_bytes(self) -> float:
        return work.windowed_rmatvec_bytes(*self._shape())

    # --- the judge ---------------------------------------------------------
    def program_outputs(self) -> dict:
        from photon_tpu_torch.ops.objective import matvec

        x = self.last.model.coefficients.means
        n = len(self.arrays["labels"])
        margins = (matvec(self.batch, x) + self.batch.offsets)[:n]

        def host(t):
            return t.to("cpu", torch.float64).numpy()

        return {"paths": [host(p) for p in self.paths], "value": self.values[-1],
                "x": host(x), "margins": host(margins)}

    def release(self) -> None:
        """Free the program's device state; host outputs stay."""
        self.outputs = self.program_outputs()
        self.batch = self.last = self.paths = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, dtype=torch.float64, fault=None) -> dict:
        out = owlqn.fit(self.arrays, self.fit_spec, device=self.device, dtype=dtype, fault=fault)
        out["paths"] = [out["path"]]
        return out

    def control(self) -> tuple[dict, str]:
        """The control's outputs on this cell's inputs: the reference
        computed in bfloat16 in the program's place. (The port's own
        bfloat16 feature path is exact on this data, whose values are all
        1, so it computes nothing in a lower precision.)"""
        return self.reference(dtype=torch.bfloat16), "the reference in bfloat16"

    def compare(self, got: dict, want: dict) -> dict:
        """The numbers compared: the worst step's relative gap of the
        objective after each of iterations 1-4 (the training, from a cold
        start); the last step's reported objective against the reference's
        objective at the last step's coefficients (the loss and its
        reductions); the relative error of the margins at those
        coefficients (the forward pass); and how far the reference's
        objective at those coefficients lies above the reference's own at
        the iteration cap (negative below it). Coefficients at the cap are
        not compared: the path there follows rounding."""
        k = PATH_ITERATIONS + 1
        at_x = want["objective_fn"](got["x"])
        return {
            "path_rel": max(compare.path_gap(p[:k], want["path"][:k]) for p in got["paths"]),
            "objective_own_rel": compare.rel_gap(got["value"], at_x),
            "margins_own_rel": compare.rel_l2(got["margins"], want["margins_fn"](got["x"])),
            "final_gap_rel": (at_x - want["value"]) / abs(want["value"]),
        }

    def diagnostics(self, got: dict, want: dict) -> dict:
        """Readings that are not compared: the last path's gaps after each
        of iterations 1-10, each side's share of nonzero coefficients and
        the overlap of the two supports (shared over either's)."""
        got_nz, want_nz = np.asarray(got["x"]) != 0, np.asarray(want["x"]) != 0
        either = int(np.sum(got_nz | want_nz))
        return {"path_gaps": compare.path_gaps(got["paths"][-1][:11], want["path"][:11]).tolist(),
                "nonzero_share": float(got_nz.mean()), "reference_nonzero_share":
                float(want_nz.mean()),
                "support_overlap": float(np.sum(got_nz & want_nz) / either) if either else 1.0}

    def attempted(self) -> int:
        return len(self.values)
