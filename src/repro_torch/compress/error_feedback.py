"""Per-sender error-feedback state (``repro.compress.error_feedback``).

Every compressing sender keeps the residual of its own last transmission and
folds it into the next one:

    target_t  = v_t + e_{t-1}
    payload_t = encode(target_t)
    e_t       = target_t - decode(payload_t)

so ``Σ_t decode_t = Σ_t v_t − e_T`` holds exactly: nothing is lost, only
delayed.  State is keyed by any hashable sender id (``("dev", id)``,
``("u", node)``, ``("g", node)``) and persists across rounds; senders that
sit a round out keep their residual.
"""
from __future__ import annotations

from typing import Dict, Hashable, Tuple

import torch

from .base import Compressed, Compressor


class ErrorFeedback:
    """Residual ledger for one simulation (persists across rounds)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.residual: Dict[Hashable, torch.Tensor] = {}

    def step(self, sender: Hashable, vec: torch.Tensor, compressor: Compressor,
             seed: int = 0) -> Tuple[Compressed, torch.Tensor]:
        """Compress ``vec`` on behalf of ``sender``; returns (payload,
        decoded) and rolls the sender's residual forward."""
        target = vec.float()
        if self.enabled and sender in self.residual:
            target = target + self.residual[sender]
        comp = compressor.encode(target, seed=seed)
        decoded = compressor.decode(comp)
        if self.enabled:
            self.residual[sender] = target - decoded
        return comp, decoded

    def residual_norm(self, sender: Hashable) -> float:
        r = self.residual.get(sender)
        return 0.0 if r is None else float(torch.linalg.vector_norm(r))
