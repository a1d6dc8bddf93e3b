"""Utilities: flat-vector <-> parameter-tree conversion and
rematerialization."""

from .flatten import TrainableRavel
from .remat import checkpoint

__all__ = ["TrainableRavel", "checkpoint"]
