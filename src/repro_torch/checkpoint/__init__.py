from .checkpoint import AsyncCheckpointer, restore, save

__all__ = ["AsyncCheckpointer", "restore", "save"]
