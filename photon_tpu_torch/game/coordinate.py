"""GAME coordinates: device-resident training and scoring units.

Counterpart of photon_tpu/game/coordinate.py.

- ``FixedEffectCoordinate`` keeps the shard on the device as a dense
  block or a padded-ELL batch (with the column-window layout on the card);
  training is one solve on the residual offsets in the normalization's
  transformed space, scoring one matvec plus the margin shift.
- ``RandomEffectCoordinate`` keeps size-bucketed entity blocks; training
  is one lane-batched L-BFGS per bucket, scoring a gather, a row dot and
  a write to each kept sample's (unique) position.
- ``MatrixFactorizationCoordinate`` keeps the two factor tables [R, k] and
  [C, k]; training is one joint L-BFGS over both, its gradient from
  autograd through the per-sample row gathers.

``sweep_step`` is the coordinate-descent step: residual = total − own
score, train on it, rescore, fold the new score back into the total.

Mesh (``mesh=``, parallel/mesh.py; one process per rank, all running the
same fit; ``LOCAL`` by default, a mesh of one rank whose collectives hand
back their input, so a fit off the mesh takes the same path): a fixed effect keeps this rank's rows of the batch (and its
instance shard of a window layout) and its solve reduces over every
rank; a random effect keeps its entity shard's lanes of every bucket and
solves them with no collective at all, then its score sums the disjoint
entity pieces over the entity axis; matrix factorization keeps this
rank's rows with the factor tables replicated. Scores, totals and the
states of fixed effects and factor tables are the same on every rank.
A random effect's state is this rank's lanes: ``global_state`` gathers
the whole entity axis (export, checkpoint, validation) and
``place_state`` takes a whole one back to this rank's lanes. Health rows
of a random effect are computed off the mesh only, as in JAX: on it they
would describe this rank's entities alone.

Work counter (``obs.record_dispatch``): a ``sweep_step`` is one launch
site, as JAX's fused step is one compiled program (the port has no
unfused variant; the ``train`` and ``score`` it calls count as part of
it), and ``train`` or ``score`` called on its own is one, as in JAX.
These are coordinate-level sites, not CUDA kernels: a step launches
many.

Spans (recorded while telemetry is on): a sweep step's two programs,
``coordinate.train`` and ``coordinate.score``, each with the coordinate
id of the enclosing ``collective_scope``; ``re.bucket`` around each
lane-batched solve of a random effect (lanes, rows, d). The build's
stages are ``obs.stage`` spans, whose walls also land in the fit's
``last_fit_stats["build_stages"]``: ``build.fe_windows`` around the
fixed effect's host window layout and ``build.placement`` around each
coordinate's host-to-device copies (the fixed effect's ELL, columns and
windows; each random-effect bucket's ``place``).

Placement: each random-effect bucket goes to the device inside
``retry_call(..., label="device_put")`` with the fault point
``coordinate.placement`` inside the retried thunk, as JAX's
``put_with_retry`` does; a failed attempt's tensors are dropped before
the retry.

Program keys (:class:`ProgramKeys`), JAX's AOT cache keys: a coordinate's
sweep step is its ``("sweep", False)`` program and a score called on its
own its ``("score",)`` program (the port never donates). The first dispatch
at a key no warm-up covered is compile_watch's one-time cost, as JAX's
first call of a jit program compiles it; so an unwarmed fit counts its
sweep programs in sweep 0's ``compiles`` and 0 after. For a random
effect one sweep key holds every bucket shape, as JAX's fused sweep
holds every bucket as a sub-solve. :meth:`Coordinate.precompile_specs`
lists ``(key, label, warm_fn)`` per program for
``descent.precompile_coordinates``: ``warm_fn()`` runs that program once
on the coordinate's own resident tensors, from a throwaway state, with
the optimizer capped at one iteration (its line search included), and
touches no state, score, work counter or fault point of the fit.
"""
from __future__ import annotations

import dataclasses
import functools
import types

import numpy as np
import torch

from photon_tpu_torch import obs
from photon_tpu_torch.data.dataset import choose_sparse
from photon_tpu_torch.game.config import (
    FeatureRepresentation,
    FixedEffectCoordinateConfig,
    MatrixFactorizationCoordinateConfig,
    RandomEffectCoordinateConfig,
)
from photon_tpu_torch.game.data import (
    PAD_ENTITY_KEY,
    GameData,
    RandomEffectDataset,
    entity_row_indices,
)
from photon_tpu_torch.game.model import (
    BucketCoefficients,
    Coefficients,
    FixedEffectModel,
    MatrixFactorizationModel,
    RandomEffectModel,
)
from photon_tpu_torch.obs.health import sweep_health
from photon_tpu_torch.ops import cuda_build
from photon_tpu_torch.ops.losses import POSITIVE_RESPONSE_THRESHOLD, loss_for_task
from photon_tpu_torch.ops.normalization import NormalizationContext
from photon_tpu_torch.ops.objective import matvec
from photon_tpu_torch.ops.sparse_windows import (
    column_windows_from_numpy,
    maybe_window_layout,
    windows_wanted,
)
from photon_tpu_torch.optimize import lane_lbfgs
from photon_tpu_torch.optimize.lbfgs import minimize_lbfgs
from photon_tpu_torch.optimize.problem import GLMProblem, GLMProblemConfig
from photon_tpu_torch.parallel.distributed import fetch_global
from photon_tpu_torch.parallel.mesh import (
    LOCAL,
    RE_FOLD_SITE,
    ROW_GATHER_SITE,
    SCORE_GATHER_SITE,
    all_reduce_sum,
    collective_scope,
    current_scope,
    entity_range,
    gather_entities,
    gather_rows,
    pad_rows_to_multiple,
    row_range,
    shard_batch,
)
from photon_tpu_torch.parallel.sparse import shard_windows
from photon_tpu_torch.types import LabeledBatch, SparseBatch, numpy_dtype
from photon_tpu_torch.util import compile_watch, faults
from photon_tpu_torch.util.retry import RetryPolicy, is_transient, retry_call

Tensor = torch.Tensor

#: JAX's AOT cache keys (photon_tpu/game/coordinate.py:222-236); the
#: port's programs never donate their inputs
SWEEP_KEY = ("sweep", False)
SCORE_KEY = ("score",)

#: bucket placement retries: JAX's put_with_retry schedule (3 attempts,
#: 20 s doubling to a 2-minute cap, ±10% jitter)
PLACEMENT_RETRY_POLICY = RetryPolicy(attempts=3, base_s=20.0, multiplier=2.0, cap_s=120.0,
                                     jitter=0.1)


def _use_sparse(representation: FeatureRepresentation, shard, dtype, bf16=False) -> bool:
    if representation == FeatureRepresentation.SPARSE:
        return True
    if representation == FeatureRepresentation.DENSE:
        return False
    itemsize = 2 if bf16 else torch.empty((), dtype=dtype).element_size()
    return choose_sparse(shard.num_rows, shard.num_cols, len(shard.values), itemsize)


def _to_host(t: Tensor) -> np.ndarray:
    """A host copy that owns its memory (never a view of a live state)."""
    return t.detach().to("cpu", torch.float64).numpy().copy()


def down_sampled_weights(data: GameData, rate: float, classification: bool, seed: int):
    """The fixed effect's down-sampling mask: one uniform draw per row from
    ``default_rng(seed)``; classification zeroes the dropped negatives and
    reweights the kept ones by 1/rate, other tasks zero the dropped rows."""
    weights = np.asarray(data.weights, dtype=np.float64).copy()
    if not 0.0 < rate < 1.0:
        return weights
    keep_draw = np.random.default_rng(seed).uniform(size=data.num_samples) < rate
    if classification:
        neg = data.labels <= POSITIVE_RESPONSE_THRESHOLD
        weights[neg & ~keep_draw] = 0.0
        weights[neg & keep_draw] /= rate
    else:
        weights[~keep_draw] = 0.0
    return weights


def fold_residual(offsets: Tensor, sample_pos: Tensor, res_pad: Tensor) -> Tensor:
    """offsets + the residual gathered by sample position; ``res_pad`` is
    the [N] residual with a zero sentinel appended at index N, which
    padding positions (≥ N) read. The same elementwise ops on the card and
    on the host, so a host fold equals a device fold bit for bit."""
    n = res_pad.shape[0] - 1
    return offsets + res_pad[torch.clamp(sample_pos, max=n)]


def solve_lanes(problem_config: GLMProblemConfig, features: Tensor, labels: Tensor,
                offsets: Tensor, weights: Tensor, w0: Tensor):
    """One lane-batched solve of independent per-entity problems:
    features [B, rows, d], the row vectors [B, rows], w0 [B, d]. A
    materialized bucket (B = E) and a streaming chunk of its entity lanes
    (B = ec) both solve through this function. Where
    ``lane_lbfgs.plain_loop_reason`` finds nothing against it (L-BFGS with
    L2 on a CUDA block within the caps) the whole solve is one launch of
    the fused kernel, with no host sync; everything else runs the plain
    lane loop. The lanes are recorded by their route
    (``cuda_build.record_route``: the tally ``re.lanes_fused`` or
    ``re.lanes_plain`` on the registry, telemetry on or off)."""
    batch = LabeledBatch(features=features, labels=labels, offsets=offsets, weights=weights)
    problem = GLMProblem.build(problem_config)
    reason = lane_lbfgs.plain_loop_reason(problem, features)
    if cuda_build.record_route("lanes", features.device.type, reason, w0.shape[0]):
        return lane_lbfgs.minimize_lanes(problem, batch, w0)
    return problem.solve(batch, w0)


def score_rows(feats: Tensor, coef_rows: Tensor) -> Tensor:
    """Per-row dot of score rows [M, d] with their entity's coefficient
    rows [M, d]; every output row depends on its own input row only."""
    return (feats * coef_rows).sum(-1)


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def one_iteration(config: GLMProblemConfig) -> GLMProblemConfig:
    """``config`` with its optimizer capped at one iteration: a warm-up
    solve that still runs the first line search."""
    return dataclasses.replace(
        config, optimizer_config=dataclasses.replace(config.optimizer_config, max_iterations=1)
    )


def device_barrier(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (nothing on the CPU)."""
    if device.type == "cuda":
        with obs.host_sync("coordinate.warmup"):
            torch.cuda.synchronize(device)  # phl-ok: PHL002 a warm-up's end, so its wall is honest


class ProgramKeys:
    """The program keys of one coordinate: those warmed ahead of the fit
    and those the fit dispatched. A dispatch at a key in neither set is a
    one-time cost (``compile_watch.record_cold_dispatch``)."""

    def __init__(self):
        self.warmed: set = set()
        self.dispatched: set = set()

    def dispatch(self, key: tuple) -> None:
        if key not in self.warmed and key not in self.dispatched:
            compile_watch.record_cold_dispatch()
        self.dispatched.add(key)

    def warm(self, key: tuple) -> None:
        self.warmed.add(key)


class Coordinate:
    """The coordinate protocol: ``train(residual, state) -> (state, info)``,
    ``score(state)``, ``initial_state()``. A coordinate that can warm its
    programs also implements ``_train_warm`` (one capped solve) and
    ``_score`` (the score without its launch-site accounting)."""

    @property
    def programs(self) -> ProgramKeys:
        keys = self.__dict__.get("_programs")
        if keys is None:
            keys = self.__dict__["_programs"] = ProgramKeys()
        return keys

    def sweep_step(self, total: Tensor, score: Tensor, state):
        """→ (new_state, new_score, new_total, info)"""
        self.programs.dispatch(SWEEP_KEY)
        cid = current_scope()[0]
        with obs.dispatch_site():
            residual = total - score
            with obs.span("coordinate.train", coordinate=cid), \
                    collective_scope(program="train"):
                new_state, info = self.train(residual, state)
            with obs.span("coordinate.score", coordinate=cid), \
                    collective_scope(program="score"):
                new_score = self.score(new_state)
        return new_state, new_score, residual + new_score, info

    def spmd_contract(self):
        """The collectives this coordinate's programs may make on a mesh
        (analysis/spmd.py), JAX's ``spmd_contract``: by default none."""
        from photon_tpu_torch.analysis import spmd

        return spmd.SpmdContract()

    def program_flops(self) -> dict:
        """Analytic flops of one evaluation of each program key on this
        rank (the device-time breakdown's compute side, obs/fleet.py);
        empty for a coordinate with no count."""
        return {}

    @property
    def has_health(self) -> bool:
        """Whether a sweep step's result gives this coordinate's health row."""
        return True

    def place_state(self, state):
        """A state loaded on the host (checkpoint resume, warm start)
        where this coordinate keeps its state: on the fit's device."""
        if isinstance(state, Tensor):
            # phl-ok: PHL007 a loaded fixed-effect d-vector or MF factor table is replicated by contract (JAX replicates them too); a random effect overrides this with its entity_range
            return state.to(self.device)
        return type(state)(self.place_state(s) for s in state)

    def global_state(self, state):
        """The whole state (every entity shard's lanes), on every rank; a
        state that is the same on every rank is already whole."""
        return state

    def precompile_specs(self, include_sweep: bool = True) -> list:
        """``(key, label, warm_fn)`` for every program a fit dispatches on
        this coordinate, JAX's ``(key, label, Lowered)``: the sweep step
        (unless ``include_sweep`` is off, as for a locked coordinate) and
        the score. ``warm_fn()`` runs the program once and marks its key
        warmed. NotImplementedError for a coordinate with no warm-up."""
        if type(self)._train_warm is Coordinate._train_warm:
            raise NotImplementedError(f"{type(self).__name__} has no warm-up")
        out = []
        if include_sweep:
            out.append((SWEEP_KEY, "sweep", self._warmer(SWEEP_KEY, self._warm_sweep)))
        out.append((SCORE_KEY, "score", self._warmer(SCORE_KEY, self._warm_score)))
        return out

    def _train_warm(self, residual_scores: Tensor, state):
        raise NotImplementedError

    def _warmer(self, key: tuple, run):
        def warm_fn():
            self.programs.warm(key)
            run()
            device_barrier(self.device)
        return warm_fn

    def _warm_sweep(self) -> None:
        """One sweep step's work from a throwaway state: a one-iteration
        solve on a zero residual, its health triple and its score."""
        residual = torch.zeros(self.num_samples, dtype=self.dtype, device=self.device)
        with collective_scope(program="train"):
            state, info = self._train_warm(residual, self.initial_state())
        sweep_health(state, info)
        with collective_scope(program="score"):
            self._score(state)

    def _warm_score(self) -> None:
        with collective_scope(program="score"):
            self._score(self.initial_state())


@dataclasses.dataclass(eq=False)
class FixedEffectCoordinate(Coordinate):
    config: FixedEffectCoordinateConfig
    batch: LabeledBatch | SparseBatch
    normalization: NormalizationContext
    problem: GLMProblem
    dtype: torch.dtype
    device: torch.device
    num_features: int
    #: the mesh whose rank holds the batch's rows (LOCAL: every row)
    mesh: object = LOCAL

    @property
    def feature_shard(self) -> str:
        return self.config.feature_shard

    @staticmethod
    def build(
        data: GameData,
        config: FixedEffectCoordinateConfig,
        normalization: NormalizationContext = NormalizationContext(),
        *,
        dtype: torch.dtype,
        device: torch.device,
        seed: int = 0,
        mesh=LOCAL,
    ) -> "FixedEffectCoordinate":
        """On a ``mesh``: keep this rank's rows (``data`` is padded to the
        mesh size) and this rank's instance shard of the window layout,
        both cut on the host so no device holds the whole block."""
        shard = data.feature_shards[config.feature_shard]
        opt = config.optimization
        weights = down_sampled_weights(
            data, opt.down_sampling_rate, opt.task.is_classification, seed
        )
        # the tensors are built where they stay, or on the host to be cut
        # to this rank's part
        fit_device, device = device, (torch.device("cpu") if mesh.distributed else device)

        def col(a):
            # phl-ok: PHL007 on a mesh ``device`` is the CPU here and shard_batch below keeps this rank's rows
            return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)

        feat_dtype = torch.bfloat16 if config.bf16_features else dtype
        windows = None
        placement = functools.partial(obs.stage, "build.placement", shard=config.feature_shard)
        if _use_sparse(config.representation, shard, dtype, config.bf16_features):
            ell_idx, ell_val = shard.to_ell(dtype=numpy_dtype(dtype))
            with placement():
                # phl-ok: PHL007 on a mesh ``device`` is the CPU here and shard_batch below keeps this rank's rows
                values = torch.as_tensor(ell_val).to(device=device, dtype=feat_dtype)
            if config.bf16_features:
                # the window layout holds the same (rounded) values
                ell_val = values.to("cpu", dtype).numpy()
            with obs.stage("build.fe_windows", shard=config.feature_shard):
                layout = maybe_window_layout(
                    ell_idx, ell_val, shard.num_cols, device=device,
                    force=config.column_windows or windows_wanted(fit_device, shard.num_cols),
                )
            with placement():
                if layout is not None:
                    windows = column_windows_from_numpy(layout, device=device, dtype=dtype)
                batch = SparseBatch(
                    # phl-ok: PHL007 on a mesh ``device`` is the CPU here and shard_batch below keeps this rank's rows
                    indices=torch.as_tensor(ell_idx).to(device=device),
                    values=values,
                    labels=col(data.labels),
                    offsets=col(data.offsets),
                    weights=col(weights),
                    windows=windows,
                )
        else:
            with placement():
                batch = LabeledBatch(
                    # phl-ok: PHL007 on a mesh ``device`` is the CPU here and shard_batch below keeps this rank's rows
                    features=torch.as_tensor(shard.to_dense(dtype=numpy_dtype(dtype))).to(
                        device=device, dtype=feat_dtype
                    ),
                    labels=col(data.labels),
                    offsets=col(data.offsets),
                    weights=col(weights),
                )
        if mesh.distributed:
            batch = shard_batch(batch, mesh)
            if windows is not None:
                batch = batch._replace(windows=shard_windows(windows, mesh, shard.num_cols))
        # phl-ok: PHL007 the normalization's d-vectors are replicated by contract, as the coefficients they scale
        normalization = normalization.to(device=fit_device, dtype=dtype)
        problem = GLMProblem.build(
            opt.with_regularization_weight(config.regularization_weights[0]), normalization,
            mesh=mesh,
        )
        return FixedEffectCoordinate(
            config=config, batch=batch, normalization=normalization,
            problem=problem, dtype=dtype, device=fit_device,
            num_features=shard.num_cols, mesh=mesh,
        )

    def with_regularization_weight(self, w: float) -> "FixedEffectCoordinate":
        self.problem = GLMProblem.build(
            self.config.optimization.with_regularization_weight(w), self.normalization,
            mesh=self.mesh,
        )
        return self

    @property
    def num_samples(self) -> int:
        return self.batch.labels.shape[0] * self.mesh.size

    def _local_rows(self, v: Tensor) -> Tensor:
        """This rank's slice of a replicated [N] vector."""
        lo, hi = row_range(self.mesh, v.shape[0])
        return v[lo:hi]

    def initial_state(self) -> Tensor:
        return torch.zeros(self.num_features, dtype=self.dtype, device=self.device)

    def train(self, residual_scores: Tensor, state: Tensor):
        obs.record_dispatch()
        res = self.problem.solve(
            self.batch, state, extra_offsets=self._local_rows(residual_scores)
        )
        return res.x, res

    def _train_warm(self, residual_scores: Tensor, state: Tensor):
        """``train`` capped at one iteration (through the window kernel
        when the batch has a window layout)."""
        problem = GLMProblem.build(
            one_iteration(self.problem.config), self.normalization, mesh=self.mesh
        )
        res = problem.solve(self.batch, state, extra_offsets=self._local_rows(residual_scores))
        return res.x, res

    def score(self, state: Tensor) -> Tensor:
        """x·(w .* factor) + margin shift, offsets excluded."""
        obs.record_dispatch()
        self.programs.dispatch(SCORE_KEY)
        return self._score(state)

    def _score(self, state: Tensor) -> Tensor:
        return gather_rows(self.score_batch(self.batch, state), self.mesh, SCORE_GATHER_SITE)

    def score_batch(self, batch, state: Tensor) -> Tensor:
        """The score of the rows of ``batch`` (the resident batch, or a
        streamed chunk of it)."""
        s = matvec(batch, self.normalization.effective_coefficients(state))
        if self.normalization.shifts is not None:
            s = s + self.normalization.margin_shift(state)
        return s

    def spmd_contract(self):
        """JAX's fixed-effect contract: on a mesh the solve all-reduces one
        d-vector gradient (plus scalar loss and convergence sums) per
        evaluation. Two [N] row-vector gathers come from the port's
        replicated [N] totals (ROADMAP C9) and are admitted by name alone:
        a windowed gradient's row vector and the score's."""
        from photon_tpu_torch.analysis import spmd

        if not self.mesh.distributed:
            return spmd.SpmdContract()
        itemsize = _itemsize(self.dtype)
        rows = self.num_samples * itemsize
        return spmd.SpmdContract(
            comm=spmd.CommAllowance(
                ops=("all-reduce",), max_bytes_per_site=(self.num_features + 16) * itemsize,
                reason="FE sharded solve: one d-vector gradient reduce (+ scalar loss/"
                "convergence reduces) per iteration"),
            named={
                ROW_GATHER_SITE: spmd.CommAllowance(
                    ops=("all-gather",), max_bytes_per_site=rows,
                    reason="ROADMAP C9: a windowed gradient gathers its [N] row vector once, "
                    "as JAX's sharded_windowed_rmatvec takes it replicated"),
                SCORE_GATHER_SITE: spmd.CommAllowance(
                    ops=("all-gather",), max_bytes_per_site=rows,
                    reason="ROADMAP C9: the [N] scores and totals are replicated on every rank"),
            },
        )

    def program_flops(self) -> dict:
        """2 flops per nonzero (ELL slot, or dense entry) of this rank's
        rows per feature pass: an evaluation is two passes (X·w, Xᵀr), a
        score one."""
        b = self.batch
        nnz = b.indices.numel() if isinstance(b, SparseBatch) else b.features.numel()
        return {SWEEP_KEY: 6.0 * nnz, SCORE_KEY: 2.0 * nnz}

    def to_model(self, state: Tensor) -> FixedEffectModel:
        """Original-space means; variances of the transformed-space solve."""
        variances = self.problem.variances(self.batch, state)
        return FixedEffectModel(
            coefficients=Coefficients(
                means=_to_host(self.normalization.model_to_original_space(state)),
                variances=None if variances is None else _to_host(variances),
            ),
            feature_shard=self.config.feature_shard,
            task=self.config.optimization.task,
        )


@dataclasses.dataclass(eq=False)
class _DeviceBucket:
    features: Tensor  # [E, n_act, d] ACTIVE rows only
    labels: Tensor
    offsets: Tensor
    weights: Tensor  # 0 on padding rows
    sample_pos: Tensor  # [E, n_act] int64, num_samples ⇒ padding
    score_feats: Tensor  # [M, d] every kept row, padding-free
    score_slot: Tensor  # [M] entity slot in this bucket
    score_pos: Tensor  # [M] global sample position (unique)


def _entity_shard(b, mesh, num_samples: int):
    """A host bucket (data.REBucket) as this rank places it: the bucket's
    lanes padded to a multiple of the entity shard count (zero blocks,
    sample position ``num_samples``) and cut to this rank's shard, and the
    score rows of its entities with their slots made local; with one
    entity shard that is the bucket itself."""
    if mesh.entity_shards == 1:
        return b
    e = b.features.shape[0]
    e_pad = pad_rows_to_multiple(e, mesh.entity_shards)
    lo, hi = entity_range(mesh, e_pad)

    def lanes(x, fill=0):
        if e_pad > e:
            x = np.pad(x, [(0, e_pad - e)] + [(0, 0)] * (x.ndim - 1), constant_values=fill)
        return x[lo:hi]

    mine = (b.score_slot >= lo) & (b.score_slot < hi)
    return types.SimpleNamespace(
        features=lanes(b.features), labels=lanes(b.labels),
        offsets=lanes(b.offsets), weights=lanes(b.weights),
        sample_pos=lanes(b.sample_pos, fill=num_samples),
        score_feats=b.score_feats[mine], score_slot=b.score_slot[mine] - lo,
        score_pos=b.score_pos[mine],
    )


@dataclasses.dataclass(eq=False)
class RandomEffectCoordinate(Coordinate):
    config: RandomEffectCoordinateConfig
    dataset: RandomEffectDataset
    device_buckets: list
    problem_config: GLMProblemConfig
    num_samples: int
    dtype: torch.dtype
    device: torch.device
    #: the mesh whose entity shard of the lanes the buckets hold (LOCAL:
    #: every lane)
    mesh: object = LOCAL

    @staticmethod
    def build(
        dataset: RandomEffectDataset,
        config: RandomEffectCoordinateConfig,
        *,
        dtype: torch.dtype,
        device: torch.device,
        mesh=LOCAL,
    ) -> "RandomEffectCoordinate":
        """On a ``mesh`` each bucket's entity axis is padded to a multiple of
        the entity shard count (padding lanes carry zero weights and the
        out-of-range sample position, so they train to zero at once), and
        this rank keeps its shard's lanes and the score rows of its
        entities (``dataset`` was built with ``entity_shards``)."""
        def place(b) -> _DeviceBucket:
            # inside the retried thunk: an injected transient fault takes
            # the real retry path (each retry counts an occurrence)
            faults.fault_point("coordinate.placement")
            b = _entity_shard(b, mesh, dataset.num_samples)
            placed = {}
            try:
                for name in ("features", "labels", "offsets", "weights", "score_feats"):
                    # phl-ok: PHL007 ``b`` is this rank's entity_range of the bucket (_entity_shard above)
                    placed[name] = torch.as_tensor(getattr(b, name)).to(device=device,
                                                                         dtype=dtype)
                for name in ("sample_pos", "score_slot", "score_pos"):
                    # phl-ok: PHL007 ``b`` is this rank's entity_range of the bucket (_entity_shard above)
                    placed[name] = torch.as_tensor(getattr(b, name)).to(device=device,
                                                                         dtype=torch.int64)
                return _DeviceBucket(**placed)
            except BaseException:
                placed.clear()  # the retry must not hold this attempt's tensors
                raise

        with obs.stage("build.placement", random_effect=config.random_effect_type):
            device_buckets = [
                retry_call(lambda b=b: place(b), policy=PLACEMENT_RETRY_POLICY,
                           classify=is_transient, label="device_put")
                for b in dataset.buckets
            ]
        return RandomEffectCoordinate(
            config=config,
            dataset=dataset,
            device_buckets=device_buckets,
            problem_config=config.optimization.with_regularization_weight(
                config.regularization_weights[0]
            ),
            num_samples=dataset.num_samples,
            dtype=dtype,
            device=device,
            mesh=mesh,
        )

    @property
    def has_health(self) -> bool:
        return not self.mesh.distributed

    def place_state(self, state: list) -> list:
        """Whole bucket states (checkpoint resume, warm start) → this
        rank's lanes on the device: each is padded to the bucket's padded
        entity count and cut to this rank's entity shard."""
        out = []
        for db, w in zip(self.device_buckets, state):
            w = torch.as_tensor(w)
            e_pad = db.features.shape[0] * self.mesh.entity_shards
            if w.shape[0] < e_pad:
                w = torch.cat([w, w.new_zeros((e_pad - w.shape[0],) + tuple(w.shape[1:]))])
            lo, hi = entity_range(self.mesh, e_pad)
            out.append(w[lo:hi].to(device=self.device, dtype=self.dtype))
        return out

    def global_state(self, state: list) -> list:
        return [gather_entities(w, self.mesh) for w in state]

    def with_regularization_weight(self, w: float) -> "RandomEffectCoordinate":
        self.problem_config = self.config.optimization.with_regularization_weight(w)
        return self

    def initial_state(self) -> list[Tensor]:
        return [
            torch.zeros(
                (b.features.shape[0], b.features.shape[2]),
                dtype=self.dtype, device=self.device,
            )
            for b in self.device_buckets
        ]

    def _solve_bucket(self, db: _DeviceBucket, w0: Tensor, res_pad: Tensor, config=None):
        """One lane-batched solve over every entity of one size bucket; the
        residual is gathered by sample position (padding reads the zero
        sentinel at index num_samples)."""
        return solve_lanes(
            config or self.problem_config, db.features, db.labels,
            fold_residual(db.offsets, db.sample_pos, res_pad), db.weights, w0,
        )

    def train(self, residual_scores: Tensor, state: list[Tensor]):
        obs.record_dispatch()
        return self._train(residual_scores, state)

    def _train(self, residual_scores: Tensor, state: list[Tensor], config=None):
        res_pad = torch.cat([residual_scores, residual_scores.new_zeros(1)])
        infos = []
        for db, w0 in zip(self.device_buckets, state):
            lanes, rows, d = db.features.shape
            with obs.span("re.bucket", cat="solver", lanes=lanes, rows=rows, d=d):
                infos.append(self._solve_bucket(db, w0, res_pad, config))
        return [r.x for r in infos], infos

    def _train_warm(self, residual_scores: Tensor, state: list[Tensor]):
        """``_train`` capped at one iteration: every bucket shape of the
        one sweep program, on the resident buckets (no copy of them)."""
        return self._train(residual_scores, state, one_iteration(self.problem_config))

    def score(self, state: list[Tensor]) -> Tensor:
        """Flat scoring: each kept sample's compacted row dotted with its
        entity's coefficients, written to its position. Every kept sample
        appears once per coordinate, so the writes never collide."""
        obs.record_dispatch()
        self.programs.dispatch(SCORE_KEY)
        return self._score(state)

    def _score(self, state: list[Tensor]) -> Tensor:
        out = torch.zeros(self.num_samples, dtype=self.dtype, device=self.device)
        for db, coefs in zip(self.device_buckets, state):
            out[db.score_pos] = score_rows(db.score_feats, coefs[db.score_slot])
        # each entity shard wrote its own rows and zeros elsewhere: the sum
        # over the entity axis is exact
        return all_reduce_sum(out, self.mesh, self.mesh.entity_group, RE_FOLD_SITE)

    def spmd_contract(self):
        """JAX's random-effect contract: the solves share nothing between
        entity shards (collective-free); the score folds each shard's rows
        into the [N] total, one [N] all-reduce over the entity axis."""
        from photon_tpu_torch.analysis import spmd

        if not self.mesh.distributed:
            return spmd.SpmdContract()
        itemsize = max(_itemsize(self.dtype), 4)
        fold = spmd.CommAllowance(
            ops=("all-reduce",),
            max_bytes_per_site=(self.num_samples + self.mesh.size + 64) * itemsize,
            reason="RE score fold: one [n]-row reduce per site (the solves themselves are "
            "collective-free)")
        return spmd.SpmdContract(comm=spmd.COLLECTIVE_FREE, comm_overrides={"score": fold})

    def program_flops(self) -> dict:
        """2·E·rows·d per evaluation of each solve shape (this rank's lanes)
        and 2 flops per score-row entry."""
        solve = sum(2.0 * db.features.numel() for db in self.device_buckets)
        score = sum(2.0 * db.score_feats.numel() for db in self.device_buckets)
        return {SWEEP_KEY: solve + score, SCORE_KEY: score}

    def to_model(self, state: list[Tensor]) -> RandomEffectModel:
        """Per-bucket coefficients and, when configured, the variances of
        each entity's problem on its active rows and data offsets. On a
        mesh every rank gathers the whole entity axis (a collective every
        rank calls) and drops the padding lanes."""
        problem = GLMProblem.build(self.problem_config)
        buckets = []
        for db, coefs, hb in zip(self.device_buckets, state, self.dataset.buckets):
            variances = problem.variances(
                LabeledBatch(db.features, db.labels, db.offsets, db.weights), coefs
            )
            e_real = len(hb.entity_ids)
            buckets.append(
                BucketCoefficients(
                    entity_ids=hb.entity_ids,
                    col_index=hb.col_index,
                    coefficients=fetch_global(coefs, self.mesh)[:e_real],
                    variances=(None if variances is None
                               else fetch_global(variances, self.mesh)[:e_real]),
                )
            )
        return RandomEffectModel(
            random_effect_type=self.config.random_effect_type,
            feature_shard=self.config.feature_shard,
            task=self.problem_config.task,
            vocab=self.dataset.vocab,
            buckets=tuple(buckets),
            num_features=self.dataset.num_features,
            projection_matrix=self.dataset.projection_matrix,
        )


@dataclasses.dataclass(eq=False)
class MatrixFactorizationCoordinate(Coordinate):
    """score = ⟨u_row, v_col⟩ on rows of positive weight. State is the pair
    (U [R, k], V [C, k]); a training step is one L-BFGS over x = [U; V]
    flattened, with the value Σ w·loss(offset + residual + ⟨u, v⟩) +
    λ/2·‖x‖²: the data term and its gradient by autograd (the row
    gathers' backward is an index_add, so on the card two runs may differ
    in the last bits), then λ/2·‖x‖² and λx added. On a mesh the rows are
    this rank's and the data term and its gradient are summed over every
    rank before the regularization is added, once."""

    config: MatrixFactorizationCoordinateConfig
    row_vocab: np.ndarray
    col_vocab: np.ndarray
    row_idx: Tensor  # [N] int64
    col_idx: Tensor  # [N] int64
    labels: Tensor
    offsets: Tensor
    weights: Tensor
    l2_weight: float
    dtype: torch.dtype
    device: torch.device
    seed: int
    #: the mesh whose rank holds the per-sample columns' rows (LOCAL: every
    #: row)
    mesh: object = LOCAL

    @staticmethod
    def build(
        data: GameData,
        config: MatrixFactorizationCoordinateConfig,
        *,
        dtype: torch.dtype,
        device: torch.device,
        seed: int = 0,
        mesh=LOCAL,
    ) -> "MatrixFactorizationCoordinate":
        r_keys = np.asarray(data.id_tags[config.row_entity_type])
        c_keys = np.asarray(data.id_tags[config.col_entity_type])
        row_vocab = np.unique(r_keys[r_keys != PAD_ENTITY_KEY])
        col_vocab = np.unique(c_keys[c_keys != PAD_ENTITY_KEY])
        # padding rows point at factor row 0 and carry weight 0
        row_idx = entity_row_indices({k: i for i, k in enumerate(row_vocab)}, r_keys, 0)
        col_idx = entity_row_indices({k: i for i, k in enumerate(col_vocab)}, c_keys, 0)

        # this rank's rows
        lo, hi = row_range(mesh, data.num_samples)
        row_idx, col_idx = row_idx[lo:hi], col_idx[lo:hi]

        def f(a):
            # phl-ok: PHL007 every caller passes this rank's row_range slice
            return torch.as_tensor(np.asarray(a, dtype=np.float64)).to(device=device, dtype=dtype)

        return MatrixFactorizationCoordinate(
            config=config,
            row_vocab=row_vocab,
            col_vocab=col_vocab,
            # phl-ok: PHL007 cut to this rank's row_range above
            row_idx=torch.as_tensor(row_idx).to(device),
            # phl-ok: PHL007 cut to this rank's row_range above
            col_idx=torch.as_tensor(col_idx).to(device),
            labels=f(data.labels[lo:hi]),
            offsets=f(data.offsets[lo:hi]),
            weights=f(data.weights[lo:hi]),
            l2_weight=float(config.regularization_weights[0]),
            dtype=dtype,
            device=device,
            seed=seed,
            mesh=mesh,
        )

    def with_regularization_weight(self, w: float) -> "MatrixFactorizationCoordinate":
        self.l2_weight = float(w)
        return self

    @property
    def num_samples(self) -> int:
        return self.labels.shape[0] * self.mesh.size

    def initial_state(self) -> tuple[Tensor, Tensor]:
        k = self.config.num_factors
        rng = np.random.default_rng(self.seed)
        scale = self.config.init_scale / np.sqrt(k)
        u = rng.normal(scale=scale, size=(len(self.row_vocab), k))
        v = rng.normal(scale=scale, size=(len(self.col_vocab), k))

        def t(a):
            # phl-ok: PHL002, PHL007 once per fit: the seeded initial factors go to the card before the first sweep, the same tables on every rank (JAX replicates them too)
            return torch.as_tensor(a).to(device=self.device, dtype=self.dtype)

        return t(u), t(v)

    def value_and_grad_fn(self, residual_scores: Tensor, shapes):
        """x ↦ (f(x), ∇f(x)) of the joint factor problem on the residual."""
        loss = loss_for_task(self.config.optimization.task)
        lo, hi = row_range(self.mesh, residual_scores.shape[0])
        offsets = self.offsets + residual_scores[lo:hi]
        (r, k), (c, _) = shapes
        l2 = self.l2_weight

        def value_and_grad(x: Tensor):
            with torch.enable_grad():
                xg = x.detach().requires_grad_(True)
                u = xg[: r * k].reshape(r, k)
                v = xg[r * k :].reshape(c, k)
                margin = offsets + (u[self.row_idx] * v[self.col_idx]).sum(-1)
                data = (self.weights * loss.loss(margin, self.labels)).sum()
                (grad,) = torch.autograd.grad(data, xg)
            data = all_reduce_sum(data.detach(), self.mesh)
            grad = all_reduce_sum(grad, self.mesh)
            x = x.detach()
            return data + 0.5 * l2 * (x * x).sum(), grad + l2 * x

        return value_and_grad

    def train(self, residual_scores: Tensor, state):
        obs.record_dispatch()
        return self._train(residual_scores, state)

    def _train(self, residual_scores: Tensor, state, optimizer_config=None):
        u0, v0 = state
        vg = self.value_and_grad_fn(residual_scores, (tuple(u0.shape), tuple(v0.shape)))
        res = minimize_lbfgs(
            vg, torch.cat([u0.reshape(-1), v0.reshape(-1)]),
            optimizer_config or self.config.optimization.optimizer_config,
        )
        n_u = u0.numel()
        return (res.x[:n_u].reshape(u0.shape), res.x[n_u:].reshape(v0.shape)), res

    def _train_warm(self, residual_scores: Tensor, state):
        """``_train`` capped at one iteration. ``state`` is the seeded
        initial draw, not zeros: at U = V = 0 the gradient is 0, the solve
        stops before its line search and the warm-up would skip it."""
        return self._train(residual_scores, state,
                           one_iteration(self.config.optimization).optimizer_config)

    def score(self, state) -> Tensor:
        obs.record_dispatch()
        self.programs.dispatch(SCORE_KEY)
        return self._score(state)

    def _score(self, state) -> Tensor:
        u, v = state
        s = (u[self.row_idx] * v[self.col_idx]).sum(-1)
        s = torch.where(self.weights > 0, s, torch.zeros_like(s))
        return gather_rows(s, self.mesh, SCORE_GATHER_SITE)

    def spmd_contract(self):
        """JAX's MF contract: the joint solve all-reduces one packed
        (R·k + C·k) factor gradient per evaluation; the score's [N] gather
        comes from the replicated totals (ROADMAP C9), admitted by name."""
        from photon_tpu_torch.analysis import spmd

        if not self.mesh.distributed:
            return spmd.SpmdContract()
        itemsize = _itemsize(self.dtype)
        packed = (len(self.row_vocab) + len(self.col_vocab)) * self.config.num_factors + 16
        return spmd.SpmdContract(
            comm=spmd.CommAllowance(
                ops=("all-reduce",), max_bytes_per_site=packed * itemsize,
                reason="MF joint solve: one packed (R·k + C·k) factor gradient reduce per "
                "iteration"),
            named={SCORE_GATHER_SITE: spmd.CommAllowance(
                ops=("all-gather",), max_bytes_per_site=self.num_samples * itemsize,
                reason="ROADMAP C9: the [N] scores and totals are replicated on every rank")},
        )

    def program_flops(self) -> dict:
        """2·N·k per evaluation (this rank's rows) and per score."""
        f = 2.0 * self.labels.shape[0] * self.config.num_factors
        return {SWEEP_KEY: 2 * f, SCORE_KEY: f}

    def to_model(self, state) -> MatrixFactorizationModel:
        return MatrixFactorizationModel(
            row_entity_type=self.config.row_entity_type,
            col_entity_type=self.config.col_entity_type,
            row_vocab=self.row_vocab,
            col_vocab=self.col_vocab,
            row_factors=_to_host(state[0]),
            col_factors=_to_host(state[1]),
        )


def build_coordinate(
    data: GameData,
    config,
    *,
    normalization: NormalizationContext = NormalizationContext(),
    re_dataset: RandomEffectDataset | None = None,
    dtype: torch.dtype,
    device: torch.device,
    seed: int = 0,
    mesh=LOCAL,
) -> Coordinate:
    """Config → coordinate (``mesh``: this rank's part of a meshed fit;
    a random effect's ``re_dataset`` is then built with the mesh's
    ``entity_shards``)."""
    if isinstance(config, FixedEffectCoordinateConfig):
        return FixedEffectCoordinate.build(
            data, config, normalization, dtype=dtype, device=device, seed=seed, mesh=mesh
        )
    if isinstance(config, RandomEffectCoordinateConfig):
        if re_dataset is None:
            raise ValueError("random-effect coordinate needs a built dataset")
        return RandomEffectCoordinate.build(
            re_dataset, config, dtype=dtype, device=device, mesh=mesh
        )
    if isinstance(config, MatrixFactorizationCoordinateConfig):
        return MatrixFactorizationCoordinate.build(
            data, config, dtype=dtype, device=device, seed=seed, mesh=mesh
        )
    raise TypeError(f"unknown coordinate config {type(config)}")
