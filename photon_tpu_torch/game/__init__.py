from photon_tpu_torch.game.config import (  # noqa: F401
    FeatureRepresentation,
    FixedEffectCoordinateConfig,
    RandomEffectCoordinateConfig,
)
from photon_tpu_torch.game.data import CSRMatrix, GameData  # noqa: F401
from photon_tpu_torch.game.estimator import GameEstimator  # noqa: F401
from photon_tpu_torch.game.model import (  # noqa: F401
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
)
from photon_tpu_torch.game.scoring import GameScorer  # noqa: F401
