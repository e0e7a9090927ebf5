"""GameTransformer: score a GameData with a trained GameModel.

Counterpart of photon_tpu/game/transformer.py: the host path (numpy per
coordinate over the whole dataset, float64) that the device scorers are
held to; the metrics run on ``device`` ("cuda" by default, raising
without a card unless "cpu" is asked for).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from photon_tpu_torch.evaluation.evaluators import EvaluatorType, evaluate
from photon_tpu_torch.evaluation.multi import MultiEvaluator
from photon_tpu_torch.game.data import GameData
from photon_tpu_torch.game.model import GameModel
from photon_tpu_torch.types import TaskType, resolve_device


@dataclasses.dataclass
class GameTransformer:
    model: GameModel
    task: TaskType
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def score(self, data: GameData) -> np.ndarray:
        """Total margin per sample: Σ coordinate scores + data offsets."""
        return self.model.score(data) + data.offsets

    def streaming_scorer(self, **kwargs):
        """The streaming device scorer of this model (GameScorer) on this
        device; ``kwargs`` reach its constructor (``batch_rows``,
        ``dtype``). Raises UnsupportedModelLayout for a
        layout it cannot express."""
        from photon_tpu_torch.game.scoring import GameScorer

        return GameScorer(self.model, device=self.device, **kwargs)

    def predict(self, data: GameData) -> np.ndarray:
        return self.model.predict(data)

    def evaluate(self, data: GameData, evaluator: EvaluatorType) -> float:
        def t(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float64)).to(self.device)

        return float(evaluate(evaluator, t(self.score(data)), t(data.labels), t(data.weights)))

    def evaluate_grouped(self, data: GameData, evaluator: MultiEvaluator, id_tag: str) -> float:
        """Per-entity grouped evaluation."""
        return evaluator(self.score(data), data.labels, data.id_tags[id_tag])
