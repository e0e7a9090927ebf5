"""Model diagnostics and reporting.

Counterpart of photon_tpu/diagnostics (reference photon-diagnostics):
assembles a system report plus per-model diagnostic reports (reference
reporting/reports/: SystemReport + ModelDiagnosticReport → DiagnosticReport,
consumed by the legacy Driver's DIAGNOSED stage, Driver.scala:608-640) and
renders them to a self-contained HTML file, a text file and a JSON dict.
Margins, moments and the bootstrap and learning-curve retrains run on the
device (the card unless the caller asks for the CPU); the statistics and
the rendering run on the host.
"""
from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np
import torch

from photon_tpu_torch.data.dataset import to_device_auto_batch
from photon_tpu_torch.diagnostics.bootstrap import (
    BootstrapReport,
    bootstrap_diagnostic,
)
from photon_tpu_torch.diagnostics.fitting import FittingReport, fitting_diagnostic
from photon_tpu_torch.diagnostics.hl import (
    HosmerLemeshowReport,
    hosmer_lemeshow,
)
from photon_tpu_torch.diagnostics.importance import (
    ImportanceReport,
    importance_from_batch,
)
from photon_tpu_torch.diagnostics.independence import (
    KendallTauReport,
    prediction_error_independence,
)
from photon_tpu_torch.diagnostics.metrics import compute_metrics
from photon_tpu_torch.diagnostics.reporting import (
    BarChart,
    Chapter,
    Document,
    LineChart,
    Section,
    Table,
    Text,
    render_html,
    render_text,
)
from photon_tpu_torch.optimize.problem import GLMProblemConfig
from photon_tpu_torch.types import TaskType, resolve_device

__all__ = [
    "BootstrapReport",
    "FittingReport",
    "HosmerLemeshowReport",
    "ImportanceReport",
    "KendallTauReport",
    "bootstrap_diagnostic",
    "compute_metrics",
    "diagnose_models",
    "fitting_diagnostic",
    "hosmer_lemeshow",
    "importance_from_batch",
    "prediction_error_independence",
    "render_html",
    "render_text",
]


def _fmt(v: float) -> str:
    return f"{v:.6g}"


def _roc_points(
    scores: np.ndarray, labels: np.ndarray, max_points: int = 200
) -> tuple[list[float], list[float]]:
    """Exact ROC sweep downsampled to ≤``max_points`` polyline vertices.

    Tied scores collapse to ONE vertex per distinct threshold — a constant
    scorer must plot as the chance diagonal, not an order-dependent
    staircase."""
    s = np.asarray(scores, dtype=np.float64)
    order = np.argsort(-s, kind="stable")
    s_sorted = s[order]
    pos = (np.asarray(labels, dtype=np.float64)[order] > 0.5).astype(
        np.float64
    )
    tp = np.concatenate([[0.0], np.cumsum(pos)])
    fp = np.concatenate([[0.0], np.cumsum(1.0 - pos)])
    # vertex after each distinct-threshold group (plus the origin)
    ends = np.concatenate(
        [[0], np.nonzero(np.diff(s_sorted))[0] + 1, [len(s_sorted)]]
    )
    tp, fp = tp[ends], fp[ends]
    p, f = max(tp[-1], 1.0), max(fp[-1], 1.0)
    tpr, fpr = tp / p, fp / f
    if len(tpr) > max_points:
        idx = np.linspace(0, len(tpr) - 1, max_points).astype(int)
        tpr, fpr = tpr[idx], fpr[idx]
    return [float(x) for x in fpr], [float(y) for y in tpr]


def diagnose_models(
    models: Sequence,
    data,
    task: TaskType,
    *,
    output_dir: str | None = None,
    train_data=None,
    config=None,
    normalization=None,
    best_index: int = 0,
    index_to_name=None,
    bootstrap_replicates: int = 8,
    fitting_fractions: Sequence[float] = (0.25, 0.5, 1.0),
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device="cuda",
) -> dict:
    """Run the full diagnostic suite over per-λ trained models.

    ``models`` — list of TrainedModel (λ, model, history) rows;
    ``data`` — validation DataSet; ``train_data`` — optional training
    DataSet enabling the retraining diagnostics (bootstrap + fitting),
    which are run on ``models[best_index]`` (the validation-selected model)
    using the caller's actual ``config`` (optimizer/regularization settings)
    and ``normalization`` so the retrains match how the model was trained.
    Returns a JSON-able report dict; writes ``report.html`` / ``report.txt``
    / ``report.json`` under ``output_dir`` when given.

    The batches are built at ``dtype`` (float32, as JAX's) on ``device``:
    the card unless ``device="cpu"``; without a card the default raises.
    The models' coefficients must lie on that device.
    """
    dev = resolve_device(device)
    batch = to_device_auto_batch(data, dtype=dtype, device=dev)
    n = data.num_samples
    report: dict = {"task": task.value, "models": []}
    chapters: list[Chapter] = []

    # --- System chapter -------------------------------------------------
    sys_sections = [
        Section(
            "Dataset",
            [
                Table(
                    ["samples", "features", "total weight"],
                    [
                        [
                            str(n),
                            str(data.num_features),
                            _fmt(float(np.sum(data.weights))),
                        ]
                    ],
                )
            ],
        )
    ]
    chapters.append(Chapter("System", sys_sections))

    # --- Per-model chapters --------------------------------------------
    lambda_labels, primary_curve = [], {}
    for tm in models:
        model = tm.model
        lam = tm.regularization_weight
        sections: list[Section] = []
        entry: dict = {"lambda": lam}

        metrics = compute_metrics(model, batch, task, num_samples=n)
        entry["metrics"] = metrics
        sections.append(
            Section(
                "Metrics",
                [
                    Table(
                        ["metric", "value"],
                        [[k, _fmt(v)] for k, v in sorted(metrics.items())],
                    )
                ],
            )
        )
        lambda_labels.append(lam)
        for name, v in metrics.items():
            primary_curve.setdefault(name, []).append(v)

        margins = model.compute_margin_batch(batch)[:n]
        means = model.compute_mean(margins).detach().cpu().numpy()

        if task == TaskType.LOGISTIC_REGRESSION:
            # ROC curve (reference BinaryClassifierDiagnostic plots the
            # curve via xchart; here ≤200 polyline points from the exact
            # rank sweep)
            fpr, tpr = _roc_points(means, np.asarray(data.labels)[:n])
            sections.append(
                Section(
                    "ROC curve",
                    [
                        LineChart(
                            "Receiver operating characteristic",
                            "false positive rate",
                            "true positive rate",
                            fpr,
                            {"model": tpr, "chance": list(fpr)},
                        )
                    ],
                )
            )
            hl = hosmer_lemeshow(
                means, data.labels, data.weights
            )
            entry["hosmer_lemeshow"] = {
                "chi_square": hl.chi_square,
                "degrees_of_freedom": hl.degrees_of_freedom,
                "p_value": hl.p_value,
                "well_calibrated": hl.well_calibrated,
            }
            occupied = [b for b in hl.bins if b.count > 0]
            sections.append(
                Section(
                    "Hosmer–Lemeshow calibration",
                    [
                        LineChart(
                            "Calibration: observed vs expected positive "
                            "rate per bin",
                            "expected positive fraction",
                            "observed positive fraction",
                            [b.expected_pos / b.count for b in occupied],
                            {
                                "bins": [
                                    b.observed_pos / b.count for b in occupied
                                ],
                                "ideal": [
                                    b.expected_pos / b.count for b in occupied
                                ],
                            },
                        ),
                        Text(
                            f"χ² = {hl.chi_square:.4g} on "
                            f"{hl.degrees_of_freedom} df, "
                            f"p = {hl.p_value:.4g} — "
                            + (
                                "no evidence of miscalibration"
                                if hl.well_calibrated
                                else "model appears miscalibrated"
                            )
                        ),
                        Table(
                            ["bin", "count", "observed+", "expected+"],
                            [
                                [
                                    f"[{b.lower:.1f},{b.upper:.1f})",
                                    _fmt(b.count),
                                    _fmt(b.observed_pos),
                                    _fmt(b.expected_pos),
                                ]
                                for b in hl.bins
                                if b.count > 0
                            ],
                        ),
                    ],
                )
            )

        indep = prediction_error_independence(
            means, data.labels[:n], seed=seed
        )
        entry["error_independence"] = {
            "tau": indep.tau,
            "p_value": indep.p_value,
            "independent": indep.errors_independent,
        }
        sections.append(
            Section(
                "Prediction-error independence (Kendall τ)",
                [
                    Text(
                        f"τ = {indep.tau:.4g}, z = {indep.z_score:.3g}, "
                        f"p = {indep.p_value:.4g} on {indep.num_samples} "
                        "samples"
                    )
                ],
            )
        )

        imp = importance_from_batch(
            model.coefficients.means.detach().cpu().numpy(),
            batch,
            num_samples=n,
            top_k=20,
            index_to_name=index_to_name,
        )
        entry["top_features"] = [
            {"name": fi.name, "expected_magnitude": fi.expected_magnitude}
            for fi in imp.ranked[:10]
        ]
        sections.append(
            Section(
                "Feature importance",
                [
                    BarChart(
                        "Expected |w·x| per feature (top 20)",
                        [fi.name for fi in imp.ranked],
                        [fi.expected_magnitude for fi in imp.ranked],
                    ),
                    Table(
                        ["feature", "coefficient", "E|w·x|", "|w|·std(x)"],
                        [
                            [
                                fi.name,
                                _fmt(fi.coefficient),
                                _fmt(fi.expected_magnitude),
                                _fmt(fi.variance_importance),
                            ]
                            for fi in imp.ranked
                        ],
                    ),
                ],
            )
        )

        report["models"].append(entry)
        chapters.append(Chapter(f"Model λ = {lam}", sections))

    # Metric-vs-λ curves across the grid.
    if len(lambda_labels) > 1:
        chapters.insert(
            1,
            Chapter(
                "Regularization path",
                [
                    Section(
                        "Validation metrics vs λ",
                        [
                            LineChart(
                                "Metrics across the λ grid",
                                "log10(λ)",
                                "metric value",
                                [
                                    float(np.log10(max(l, 1e-12)))
                                    for l in lambda_labels
                                ],
                                primary_curve,
                            )
                        ],
                    )
                ],
            ),
        )

    # --- Retraining diagnostics (need training data) --------------------
    if train_data is not None and models:
        best = models[min(best_index, len(models) - 1)]
        base = config if config is not None else GLMProblemConfig(task=task)
        config = base.with_regularization_weight(best.regularization_weight)
        train_batch = to_device_auto_batch(train_data, dtype=dtype, device=dev)
        n_train = train_data.num_samples

        fit = fitting_diagnostic(
            train_batch,
            batch,
            config,
            task,
            num_samples=n_train,
            num_test_samples=n,
            fractions=list(fitting_fractions),
            normalization=normalization,
            seed=seed,
            num_features=train_data.num_features,
        )
        report["fitting"] = {
            "fractions": fit.fractions,
            "train": fit.train_metrics,
            "test": fit.test_metrics,
        }
        chapters.append(
            Chapter(
                "Fitting diagnostic",
                [
                    Section(
                        "Learning curves",
                        [
                            LineChart(
                                f"{name} vs training fraction",
                                "training fraction",
                                name,
                                fit.fractions,
                                {
                                    "train": fit.train_metrics[name],
                                    "holdout": fit.test_metrics[name],
                                },
                            )
                            for name in fit.test_metrics
                            if name in fit.train_metrics
                        ][:4]
                        or [Text("no metrics")],
                    )
                ],
            )
        )

        if bootstrap_replicates > 0:
            boot = bootstrap_diagnostic(
                train_batch,
                batch,
                config,
                task,
                num_samples=n_train,
                num_validation_samples=n,
                num_replicates=bootstrap_replicates,
                normalization=normalization,
                seed=seed,
                num_features=train_data.num_features,
            )
            report["bootstrap"] = {
                "replicates": boot.num_replicates,
                "unstable_fraction": boot.unstable_fraction,
                "metrics": {
                    k: list(v) for k, v in boot.metric_distributions.items()
                },
            }
            chapters.append(
                Chapter(
                    "Bootstrap diagnostic",
                    [
                        Section(
                            "Coefficient confidence intervals "
                            f"({boot.num_replicates} replicates)",
                            [
                                Text(
                                    f"{boot.unstable_fraction:.0%} of the top "
                                    "coefficients have intervals straddling "
                                    "zero."
                                ),
                                Table(
                                    [
                                        "feature idx",
                                        "point",
                                        "lower",
                                        "median",
                                        "upper",
                                        "stable sign",
                                    ],
                                    [
                                        [
                                            str(iv.index),
                                            _fmt(iv.point_estimate),
                                            _fmt(iv.lower),
                                            _fmt(iv.median),
                                            _fmt(iv.upper),
                                            "yes" if iv.significant else "no",
                                        ]
                                        for iv in boot.intervals
                                    ],
                                ),
                            ],
                        ),
                        Section(
                            "Metric distributions",
                            [
                                Table(
                                    ["metric", "lower", "median", "upper"],
                                    [
                                        [k, _fmt(lo), _fmt(med), _fmt(hi)]
                                        for k, (
                                            lo,
                                            med,
                                            hi,
                                        ) in boot.metric_distributions.items()
                                    ],
                                )
                            ],
                        ),
                    ],
                )
            )

    doc = Document(f"photon-tpu diagnostics — {task.value}", chapters)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "report.html"), "w") as f:
            f.write(render_html(doc))
        with open(os.path.join(output_dir, "report.txt"), "w") as f:
            f.write(render_text(doc))
        with open(os.path.join(output_dir, "report.json"), "w") as f:
            json.dump(report, f, indent=2, default=float)
    report["document"] = doc
    return report
