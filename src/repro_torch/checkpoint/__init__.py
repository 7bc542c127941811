from .checkpoint import load_checkpoint, restore_latest, save_checkpoint

__all__ = ["load_checkpoint", "restore_latest", "save_checkpoint"]
