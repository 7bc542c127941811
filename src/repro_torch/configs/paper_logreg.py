"""The paper's own model: multinomial logistic regression (§IV-A1).

dim 784 / 10 classes for the MNIST-like dataset (n = 7 850 parameters); the
synthetic datasets use dim 60 / 10 classes (construct via
``CONFIG.with_overrides(input_dim=60)``).
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="paper-logreg", family="logreg",
    input_dim=784, num_classes=10, dtype="float32",
)
