"""Shallow-water forward model and the Tōhoku scenario, in PyTorch."""
from .scenario import (
    TohokuInverseProblem,
    TohokuScenario,
    make_hierarchy,
    observe,
    train_level0_gp,
)
from .servers import make_level_servers
from .solver import SWEConfig, SWEState, lake_at_rest_error, make_solver, step

__all__ = [
    "SWEConfig",
    "SWEState",
    "TohokuInverseProblem",
    "TohokuScenario",
    "lake_at_rest_error",
    "make_hierarchy",
    "make_level_servers",
    "make_solver",
    "observe",
    "step",
    "train_level0_gp",
]
