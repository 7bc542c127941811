"""Datasets for the port: numpy copies of
``repro.data.{synthetic,federated,loader}``, and ``fleetgen``'s virtual
fleet, whose shards are generated on the card from device ids."""
from .federated import FederatedDataset, dirichlet_partition, make_federated
from .fleetgen import VirtualFleetDataset, eval_device_ids
from .loader import batch_iterator, epoch_batches
from .synthetic import (make_femnist_like, make_mnist_like, make_synthetic,
                        make_token_stream)

__all__ = [
    "FederatedDataset", "VirtualFleetDataset", "dirichlet_partition",
    "eval_device_ids", "make_federated",
    "batch_iterator", "epoch_batches", "make_femnist_like", "make_mnist_like",
    "make_synthetic", "make_token_stream",
]
