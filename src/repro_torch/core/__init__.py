"""GP surrogate, LHS design, the model protocol, MH/MALA/MLDA samplers (step
machines and the device-resident ensemble) and diagnostics."""
from .diagnostics import (
    effective_sample_size,
    gelman_rubin,
    summarize_chain,
    telescoping_estimate,
    variance_reduction_check,
)
from .gp import GaussianProcess, GPParams, fit_gp, gp_from_arrays, matern52
from .counter_rng import CounterStream, chain_keys
from .lhs import latin_hypercube, scale_to_bounds
from .mala import BalancedGradDensity, mala, mala_step
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
from .mlda_device import (
    DeviceEnsemble,
    DeviceMatchedRandomWalk,
    EnsembleState,
    MLDAResult,
    PendingProposal,
    make_device_ensemble,
    make_mlda_kernel,
    run_chains,
)
from .model import LogDensityModel, Model, ModelInfo, TorchModel

__all__ = [
    "AdaptiveMetropolis",
    "BalancedDensity",
    "BalancedGradDensity",
    "ChainState",
    "ChainStats",
    "CounterStream",
    "DeviceEnsemble",
    "DeviceMatchedRandomWalk",
    "EnsembleState",
    "GPParams",
    "GaussianProcess",
    "GaussianRandomWalk",
    "LogDensityModel",
    "MLDAResult",
    "MLDASampler",
    "Model",
    "ModelInfo",
    "PCNProposal",
    "PendingEval",
    "PendingProposal",
    "Proposal",
    "TorchModel",
    "balanced_mlda",
    "chain_keys",
    "delayed_acceptance",
    "effective_sample_size",
    "fit_gp",
    "gelman_rubin",
    "gp_from_arrays",
    "latin_hypercube",
    "make_device_ensemble",
    "make_mlda_kernel",
    "mala",
    "mala_step",
    "matern52",
    "metropolis_hastings",
    "mh_step",
    "mh_step_steps",
    "run_chains",
    "scale_to_bounds",
    "summarize_chain",
    "telescoping_estimate",
    "variance_reduction_check",
]
