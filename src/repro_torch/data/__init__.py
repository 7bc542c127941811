"""Datasets for the port: numpy copies of ``repro.data.{synthetic,federated}``."""
from .federated import FederatedDataset, dirichlet_partition, make_federated
from .synthetic import (make_femnist_like, make_mnist_like, make_synthetic,
                        make_token_stream)

__all__ = [
    "FederatedDataset", "dirichlet_partition", "make_federated",
    "make_femnist_like", "make_mnist_like", "make_synthetic",
    "make_token_stream",
]
