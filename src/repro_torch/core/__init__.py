"""GP surrogate, LHS design, MH/MLDA samplers and diagnostics."""
from .diagnostics import (
    effective_sample_size,
    gelman_rubin,
    summarize_chain,
    telescoping_estimate,
    variance_reduction_check,
)
from .gp import GaussianProcess, GPParams, fit_gp, gp_from_arrays, matern52
from .lhs import latin_hypercube, scale_to_bounds
from .mh import (
    AdaptiveMetropolis,
    ChainStats,
    GaussianRandomWalk,
    PCNProposal,
    Proposal,
    metropolis_hastings,
    mh_step,
    mh_step_steps,
)
from .mlda import (
    BalancedDensity,
    ChainState,
    MLDASampler,
    PendingEval,
    balanced_mlda,
    delayed_acceptance,
)

__all__ = [
    "AdaptiveMetropolis",
    "BalancedDensity",
    "ChainState",
    "ChainStats",
    "GPParams",
    "GaussianProcess",
    "GaussianRandomWalk",
    "MLDASampler",
    "PCNProposal",
    "PendingEval",
    "Proposal",
    "balanced_mlda",
    "delayed_acceptance",
    "effective_sample_size",
    "fit_gp",
    "gelman_rubin",
    "gp_from_arrays",
    "latin_hypercube",
    "matern52",
    "metropolis_hastings",
    "mh_step",
    "mh_step_steps",
    "scale_to_bounds",
    "summarize_chain",
    "telescoping_estimate",
    "variance_reduction_check",
]
