"""Command-line drivers and step builders of the port (``repro.launch``):
``serve``, ``train``, ``steps``, ``shapes`` and ``mesh``."""
