"""Utilities: flat-vector <-> parameter-tree conversion."""

from .flatten import TrainableRavel

__all__ = ["TrainableRavel"]
