from .hypernet import Hypernet, HypernetConfig, PassthroughHypernet
from .reference_io import load_reference_hypernet

__all__ = ["Hypernet", "HypernetConfig", "PassthroughHypernet", "load_reference_hypernet"]
