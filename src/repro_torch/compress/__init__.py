"""Sub-O(n) summary compression for the hierarchical uplink
(``repro.compress``).

A family of linear-sketch and selection compressors behind one
:class:`Compressor` protocol, plus the per-sender error-feedback state that
makes lossy uplinks convergent.  :func:`repro_torch.fl.run_hier_simulation`
with ``HierConfig.compress`` set (the ``hier_contextual_sketch`` aggregator)
ships gateway summaries through these.

  * base           — protocol, payloads + wire-size accounting, identity
                     scheme, :class:`CompressConfig` budget resolution
  * sketch         — signed random projection (``sign_sketch`` kernels) and
                     SRHT
  * topk           — magnitude top-k masking (``topk`` kernel)
  * lowrank        — rank-r factored summaries (truncated SVD)
  * error_feedback — per-sender residual state (telescoping-exact)
"""
from . import lowrank, sketch, topk  # noqa: F401  (register schemes)
from .base import (Compressed, CompressConfig, Compressor,
                   IdentityCompressor, available_schemes, payload_gram,
                   register_scheme)
from .error_feedback import ErrorFeedback
from .lowrank import LowRankCompressor
from .sketch import SignSketch, SRHTSketch, fwht
from .topk import TopKCompressor

__all__ = [
    "Compressed", "CompressConfig", "Compressor", "IdentityCompressor",
    "available_schemes", "payload_gram", "register_scheme",
    "ErrorFeedback", "LowRankCompressor", "SignSketch", "SRHTSketch",
    "fwht", "TopKCompressor",
]
