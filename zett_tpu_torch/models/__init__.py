from .hypernet import Hypernet, HypernetConfig, PassthroughHypernet

__all__ = ["Hypernet", "HypernetConfig", "PassthroughHypernet"]
