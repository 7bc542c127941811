"""Adversarial and churn robustness (``repro.robust``), in PyTorch.

  * :mod:`.attacks`    — ``AttackModel`` adversaries (byzantine_gauss,
    sign_flip, scaled_update, label_flip), adversary assignment on the
    fleet, and the stacked-corruption helpers the three runtimes share.
  * :mod:`.churn`      — time-scheduled mass-dropout and rejoin waves on the
    event scheduler.
  * :mod:`.gramstats`  — clipping and median-of-means / trimmed pooling on
    the contextual (G, c) statistics, used by the fused and streamed tier
    stages; :mod:`.aggregators` registers the flat robust variants
    (``contextual_clipped``, ``contextual_mom``, ``krum``,
    ``coordinate_median``) in ``core.aggregation``.

Importing this package registers the robust aggregators.
"""
from . import aggregators as _aggregators  # noqa: F401 (registry side effect)
from .attacks import (AttackModel, ByzantineGauss, LabelFlip, Noise,
                      ScaledUpdate, SignFlip, assign_adversaries,
                      available_attacks, corrupt_one, corrupt_stacked,
                      generator_noise, get_attack, poison_labels, stream_seed)
from .churn import ChurnSchedule, ChurnWave, churn_schedule
from .gramstats import (RobustConfig, clip_scales, median, pool_cross,
                        robustify)

__all__ = [
    "AttackModel", "ByzantineGauss", "SignFlip", "ScaledUpdate", "LabelFlip",
    "Noise", "assign_adversaries", "available_attacks", "corrupt_one",
    "corrupt_stacked", "generator_noise", "get_attack", "poison_labels",
    "stream_seed", "ChurnSchedule", "ChurnWave", "churn_schedule",
    "RobustConfig", "clip_scales", "median", "pool_cross", "robustify",
]
