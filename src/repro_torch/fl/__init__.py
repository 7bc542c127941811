from .client import client_update, draw_batch_indices, local_gradient
from .metrics import evaluate_classifier, global_train_loss
from .server import (RoundState, ServerConfig, build_round_fn, init_server,
                     sample_round)
from .simulation import (AsyncSimulationResult, HierSimulationResult,
                         SimulationResult, run_async_simulation,
                         run_hier_simulation, run_simulation)

__all__ = [
    "client_update", "draw_batch_indices", "local_gradient",
    "evaluate_classifier", "global_train_loss", "RoundState", "ServerConfig",
    "build_round_fn", "init_server", "sample_round", "AsyncSimulationResult",
    "HierSimulationResult", "SimulationResult", "run_async_simulation",
    "run_hier_simulation", "run_simulation",
]
