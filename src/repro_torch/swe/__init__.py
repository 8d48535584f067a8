"""Shallow-water forward model and the Tōhoku scenario, in PyTorch."""
from .scenario import (
    TohokuInverseProblem,
    TohokuScenario,
    build_hierarchy,
    device_densities,
    make_hierarchy,
    observe,
    train_level0_gp,
)
from .servers import (
    close_transports,
    local_level_servers,
    make_level_servers,
    make_remote_level_servers,
    stacked_factory,
)
from .solver import SWEConfig, SWEState, lake_at_rest_error, make_solver, step

__all__ = [
    "SWEConfig",
    "SWEState",
    "TohokuInverseProblem",
    "TohokuScenario",
    "build_hierarchy",
    "close_transports",
    "device_densities",
    "lake_at_rest_error",
    "local_level_servers",
    "make_hierarchy",
    "make_level_servers",
    "make_remote_level_servers",
    "make_solver",
    "observe",
    "stacked_factory",
    "step",
    "train_level0_gp",
]
