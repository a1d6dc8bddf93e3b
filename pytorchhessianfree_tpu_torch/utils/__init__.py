"""Utilities: flat-vector <-> parameter-tree conversion,
rematerialization and solver sizing."""

from .flatten import TrainableRavel
from .memory import format_solver_memory, solver_memory_bytes
from .remat import checkpoint

__all__ = [
    "TrainableRavel",
    "checkpoint",
    "format_solver_memory",
    "solver_memory_bytes",
]
