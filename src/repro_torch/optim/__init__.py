"""Optimizers, the FedProx objective and learning-rate schedules on tensor
trees (``repro.optim``): plain functions, the reference's update rules and
``NamedTuple`` states, no ``torch.optim``."""
from .optimizers import (AdamWState, OptState, SGDState, adamw_init,
                         adamw_update, make_optimizer, sgd_init, sgd_update)
from .proximal import proximal_loss_fn
from .schedules import constant, cosine_decay, linear_warmup_cosine

__all__ = [
    "AdamWState", "OptState", "SGDState", "adamw_init", "adamw_update",
    "make_optimizer", "sgd_init", "sgd_update", "proximal_loss_fn",
    "constant", "cosine_decay", "linear_warmup_cosine",
]
