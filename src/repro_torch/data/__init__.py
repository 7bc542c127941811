"""Datasets for the port: numpy copies of
``repro.data.{synthetic,federated,loader}``."""
from .federated import FederatedDataset, dirichlet_partition, make_federated
from .loader import batch_iterator, epoch_batches
from .synthetic import (make_femnist_like, make_mnist_like, make_synthetic,
                        make_token_stream)

__all__ = [
    "FederatedDataset", "dirichlet_partition", "make_federated",
    "batch_iterator", "epoch_batches", "make_femnist_like", "make_mnist_like",
    "make_synthetic", "make_token_stream",
]
