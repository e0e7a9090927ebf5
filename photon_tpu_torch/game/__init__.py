from photon_tpu_torch.game.config import (  # noqa: F401
    FeatureRepresentation,
    FixedEffectCoordinateConfig,
    MatrixFactorizationCoordinateConfig,
    ProjectorType,
    RandomEffectCoordinateConfig,
    required_id_tags,
)
from photon_tpu_torch.game.data import CSRMatrix, GameData  # noqa: F401
from photon_tpu_torch.game.estimator import GameEstimator, GameTrainingResult  # noqa: F401
from photon_tpu_torch.game.model import (  # noqa: F401
    FixedEffectModel,
    GameModel,
    MatrixFactorizationModel,
    RandomEffectModel,
)
from photon_tpu_torch.game.scoring import GameScorer, UnsupportedModelLayout  # noqa: F401
from photon_tpu_torch.game.transformer import GameTransformer  # noqa: F401
