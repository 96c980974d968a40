"""The paper's math: consensus (graphs, gossip, quantized gossip), dual
averaging, straggler models, the §6 objectives, the regret bounds and the
AMB / FMB epoch engine (counterpart of ``repro.core``)."""
from . import (consensus, dual_averaging, engine, extensions, objectives,
               regret, stragglers)
from .consensus import (build_graph, exact_average, gossip, is_connected,
                        metropolis_weights, ring_graph, torus_graph)
from .dual_averaging import (BetaSchedule, DualAveraging, prox_step,
                             prox_step_tree)
from .engine import EngineConfig, History, run, run_amb, run_fmb
from .extensions import (AdaptiveBudget, gossip_quantized,
                         quantize_unbiased, run_amb_adaptive,
                         run_amb_delayed, run_amb_pipelined,
                         run_amb_quantized)
from .stragglers import (Deterministic, InducedGroups, PauseModel,
                         ShiftedExponential, StragglerModel, amb_batch_sizes,
                         amb_budget_calibrated, amb_budget_from_fmb,
                         fmb_finish_times)

__all__ = [
    "consensus", "dual_averaging", "engine", "extensions", "objectives",
    "regret", "stragglers", "AdaptiveBudget", "BetaSchedule",
    "DualAveraging", "prox_step", "prox_step_tree", "EngineConfig",
    "History", "run", "run_amb", "run_fmb", "Deterministic",
    "InducedGroups", "PauseModel",
    "ShiftedExponential", "StragglerModel", "amb_batch_sizes",
    "amb_budget_calibrated", "amb_budget_from_fmb", "fmb_finish_times",
    "build_graph", "exact_average", "gossip", "gossip_quantized",
    "is_connected", "metropolis_weights", "quantize_unbiased", "ring_graph",
    "run_amb_adaptive", "run_amb_delayed", "run_amb_pipelined",
    "run_amb_quantized",
    "torus_graph",
]
