"""Drivers / CLI layer of the port (reference photon-client), with the
JAX package's parsers and on-disk artifacts:

- ``photon_tpu_torch.cli.game_training``    GAME training (GameTrainingDriver.scala:822)
- ``photon_tpu_torch.cli.game_scoring``     GAME scoring (GameScoringDriver.scala:260)
- ``photon_tpu_torch.cli.legacy_driver``    single-GLM staged pipeline (Driver.scala:685)
- ``photon_tpu_torch.cli.feature_indexing`` native index-store builder
  (FeatureIndexingDriver.scala:307)
- ``photon_tpu_torch.cli.name_term_bags``   feature-bag extraction
  (NameAndTermFeatureBagsDriver.scala:206)

Run as ``python -m photon_tpu_torch.cli.game_training --help`` etc.; the
training, scoring and legacy drivers run on the card, and in-process
callers pass ``run(argv, device="cpu")`` for the host.
"""
