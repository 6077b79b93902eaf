from .hypernet import Hypernet, HypernetConfig

__all__ = ["Hypernet", "HypernetConfig"]
