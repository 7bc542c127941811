from .config import ArchConfig
from .registry import ModelBundle, get_model

__all__ = ["ArchConfig", "ModelBundle", "get_model"]
