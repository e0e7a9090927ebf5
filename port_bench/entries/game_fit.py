"""Repeated cold GAME fits: what a GLMix user waits for at each λ-grid point.

Set-up makes the data from the seed and runs
``GameEstimator(..., precompile=True, keep_coordinates=True).fit(data)``:
the host build, the warm-up of every program and one whole fit. A step is
one more whole fit from cold states on the built coordinates,
``run_coordinate_descent(coordinates, order, sweeps)`` (the call
``GameEstimator._fit`` makes for one grid point), ending with the read-back
of its summed scores.

The judge fits the same data with the plain reference in float64 and
compares every step's fixed-effect objective along the first sweep's
iterations, the last step's fixed-effect and per-entity coefficients, and
every step's scores.
"""
from __future__ import annotations

import numpy as np
import torch

from port_bench.counts import work
from port_bench.gen.movielens import movielens_arrays
from port_bench.reference import compare, game

FIXED = "fixed"


class Cell:
    def __init__(self, config: dict, mix: dict, *, seed: int, device):
        self.config, self.mix, self.seed = config, mix, seed
        self.device = torch.device(device)
        self.fit_spec = config["fit"]
        self.order = [FIXED] + [re["name"] for re in self.fit_spec["random_effects"]]
        #: the configuration's type (the tests run the program at float64 too)
        self.dtype = getattr(torch, config["dtype"])
        self.scores: list[np.ndarray] = []
        #: each step's fixed-effect objective after every iteration of the
        #: first sweep (device tensors, read once the window has closed)
        self.fixed_paths: list = []
        self.coordinate_seconds: list[dict] = []
        self.last = None

    # --- the program -------------------------------------------------------
    def _estimator(self):
        from photon_tpu_torch.game import (
            FeatureRepresentation,
            FixedEffectCoordinateConfig,
            GameEstimator,
            RandomEffectCoordinateConfig,
        )
        from photon_tpu_torch.optimize.common import OptimizerConfig
        from photon_tpu_torch.optimize.problem import (
            GLMProblemConfig,
            RegularizationContext,
            RegularizationType,
        )
        from photon_tpu_torch.types import TaskType

        l2 = RegularizationContext(RegularizationType.L2)
        fe = self.fit_spec["fixed"]
        cfgs = {FIXED: FixedEffectCoordinateConfig(
            feature_shard="global",
            optimization=GLMProblemConfig(
                optimizer_config=OptimizerConfig(max_iterations=fe["max_iterations"],
                                                 ls_max_iterations=fe["line_search_trials"]),
                regularization=l2),
            regularization_weights=(fe["l2"],),
            representation=FeatureRepresentation.SPARSE,
            column_windows=fe["column_windows"],
        )}
        for re in self.fit_spec["random_effects"]:
            cfgs[re["name"]] = RandomEffectCoordinateConfig(
                random_effect_type=re["name"],
                feature_shard=f"per_{re['name']}",
                optimization=GLMProblemConfig(
                    optimizer_config=OptimizerConfig(max_iterations=re["max_iterations"],
                                                     ls_max_iterations=re["line_search_trials"]),
                    regularization=l2),
                regularization_weights=(re["l2"],),
                active_data_upper_bound=re["active_upper_bound"],
            )
        return GameEstimator(
            task=TaskType.LOGISTIC_REGRESSION, coordinate_configs=cfgs,
            update_sequence=self.order, descent_iterations=self.fit_spec["sweeps"],
            dtype=self.dtype, seed=self.seed, device=self.device,
            precompile=True, keep_coordinates=True,
        )

    def setup(self) -> None:
        from photon_tpu_torch.game import CSRMatrix, GameData

        d = {k: v for k, v in self.config["data"].items() if k != "generator"}
        self.arrays = movielens_arrays(self.seed, **d)
        a = self.arrays
        shards = {"global": CSRMatrix(indptr=a["indptr"], indices=a["indices"],
                                      values=a["values"], num_cols=a["fe_dim"])}
        tags = {}
        for name, re in a["random_effects"].items():
            shards[f"per_{name}"] = CSRMatrix.from_dense(re["features"])
            tags[name] = re["tags"]
        data = GameData.build(labels=a["labels"], feature_shards=shards, id_tags=tags)
        self.est = self._estimator()
        self.est.fit(data)
        self.host_build_s = self.est.last_fit_stats["build_s"]
        self.coordinates = self.est.last_coordinates

    def step(self, per_coordinate: bool = False) -> None:
        from photon_tpu_torch.game.descent import run_coordinate_descent

        cd = run_coordinate_descent(
            self.coordinates, self.order, self.fit_spec["sweeps"],
            tracker_granularity="coordinate" if per_coordinate else "sweep",
        )
        self.scores.append(cd.total.to("cpu", torch.float64).numpy())
        # None where the fixed effect did not train (a descent of no sweep)
        self.fixed_paths.append(next((r["info"].loss_history for r in cd.tracker
                                      if r.get("coordinate") == FIXED), None))
        self.last = cd
        if per_coordinate:
            secs = dict.fromkeys(self.order, 0.0)
            for row in cd.tracker:
                if "coordinate" in row:
                    secs[row["coordinate"]] += row["seconds"]
            self.coordinate_seconds.append(secs)

    # --- what the metric readers read --------------------------------------
    def step_work(self) -> tuple[float, float]:
        """(operations, bytes) of one step, from the last step's counters:
        the steps repeat one computation (the judge holds every step's
        scores to the reference)."""
        flops = nbytes = 0.0
        per_pass = work.sparse_pass(*self._fe_shape())
        for row in self.last.tracker:
            if "coordinate" not in row:
                continue
            info, cid = row["info"], row["coordinate"]
            if cid == FIXED:
                passes = int(info.n_feature_passes)
                flops += passes * per_pass[0]
                nbytes += passes * per_pass[1]
                continue
            coord = self.coordinates[cid]
            rpd = 0.0
            for db, res in zip(coord.device_buckets, info):
                rows = (db.weights > 0).sum(-1).to(torch.float64)
                rpd += float((res.n_feature_passes.to(torch.float64) * rows).sum()) \
                    * db.features.shape[-1]
            f, b = work.lane_passes(rpd)
            flops, nbytes = flops + f, nbytes + b
        return flops, nbytes

    def _fe_shape(self) -> tuple[int, int, int]:
        """(nonzeros, rows, columns) of the fixed effect's shard."""
        a = self.arrays
        return int(a["indptr"][-1]), len(a["labels"]), a["fe_dim"]

    def kernel_bytes(self) -> float:
        return work.windowed_rmatvec_bytes(*self._fe_shape())

    # --- the judge ---------------------------------------------------------
    def program_outputs(self) -> dict:
        out = {"scores": self.scores,
               "fixed_path": [None if p is None else p.to("cpu", torch.float64).numpy()
                              for p in self.fixed_paths]}
        states = self.last.states
        out[FIXED] = self.coordinates[FIXED].to_model(states[FIXED]).coefficients.means
        for re in self.fit_spec["random_effects"]:
            name = re["name"]
            model = self.coordinates[name].to_model(states[name])
            dim = self.arrays["random_effects"][name]["features"].shape[1]
            table = np.zeros((len(model.vocab), dim))
            for b in model.buckets:
                lane, slot = np.nonzero(b.col_index >= 0)
                table[b.entity_ids[lane], b.col_index[lane, slot]] = b.coefficients[lane, slot]
            out[name] = table
            out[f"{name}_vocab"] = np.asarray(model.vocab)
        return out

    def release(self) -> None:
        """Free the program's device state; host outputs stay."""
        self.outputs = self.program_outputs()
        self.est = self.coordinates = self.last = self.fixed_paths = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, dtype=torch.float64, fault=None) -> dict:
        return game.fit(self.arrays, self.fit_spec, seed=self.seed, device=self.device,
                        dtype=dtype, fault=fault)

    def control(self) -> tuple[dict, str]:
        """The control's outputs on this cell's inputs: the reference
        computed in bfloat16 in the program's place. (The port's own
        bfloat16 feature path is exact on this data, whose features are all
        0 or 1, so it computes nothing in a lower precision.)"""
        return self.reference(dtype=torch.bfloat16), "the reference in bfloat16"

    def compare(self, got: dict, want: dict) -> dict:
        """The numbers compared: the worst step's relative gap of the
        fixed effect's objective after each of the first sweep's
        iterations (the training, from the fixed effect's cold start); the
        last step's summed scores against the reference's scores of the
        last step's own coefficients (the scoring layer); the relative
        error of the fixed effect and of each random-effect table against
        the reference's fit (entities matched by their tags); and the worst
        step's relative error and worst row gap of the summed scores."""
        scores = got["scores"] if isinstance(got["scores"], list) else [got["scores"]]
        paths = got["fixed_path"] if isinstance(got["fixed_path"], list) else [got["fixed_path"]]
        out = {"fixed_path_rel": max(compare.path_gap(p, want["fixed_path"]) for p in paths),
               "scores_own_rel": compare.rel_l2(scores[-1], want["scores_fn"](got)),
               "fixed_rel": compare.rel_l2(got[FIXED], want[FIXED])}
        for re in self.fit_spec["random_effects"]:
            name = re["name"]
            same = np.array_equal(got[f"{name}_vocab"], want[f"{name}_vocab"])
            out[f"{name}_rel"] = compare.rel_l2(got[name], want[name]) if same else 1.0
        out["scores_rel"] = max(compare.rel_l2(s, want["scores"]) for s in scores)
        out["scores_row_gap"] = max(compare.worst_row_gap(s, want["scores"]) for s in scores)
        return out

    def diagnostics(self, got: dict, want: dict) -> dict:
        """Readings that are not compared: the last step's relative gap of
        the fixed effect's objective after every iteration of the first
        sweep."""
        path = got["fixed_path"][-1] if isinstance(got["fixed_path"], list) else got["fixed_path"]
        gaps = [] if path is None else compare.path_gaps(path, want["fixed_path"]).tolist()
        return {"fixed_path_gaps": gaps}

    def attempted(self) -> int:
        return len(self.scores)
