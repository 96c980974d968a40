"""The paper's math: dual-averaging step size, consensus (exact, gossip,
quantized gossip), stragglers."""
from .consensus import (build_graph, exact_average, gossip, is_connected,
                        metropolis_weights, ring_graph, torus_graph)
from .dual_averaging import BetaSchedule
from .extensions import gossip_quantized, quantize_unbiased
from .stragglers import (Deterministic, ShiftedExponential, StragglerModel,
                         amb_batch_sizes)

__all__ = ["BetaSchedule", "Deterministic", "ShiftedExponential",
           "StragglerModel", "amb_batch_sizes", "build_graph",
           "exact_average", "gossip", "gossip_quantized", "is_connected",
           "metropolis_weights", "quantize_unbiased", "ring_graph",
           "torus_graph"]
