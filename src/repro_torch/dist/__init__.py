"""The AMB train steps and consensus strategies (worker dim on one device):
the sequential steps (:mod:`.amb`), the staleness-1 pipelined epochs
(:mod:`.pipeline`), the AMB-DG bounded-staleness epochs
(:mod:`.async_epochs`), the strategies with their elastic survivor
relayout (:mod:`.consensus`), and coded placement (:mod:`.redundancy`)."""
from .amb import (AMBConfig, NoiseStats, assignment_from_config,
                  gossip_primal, grad_noise_stats, make_gossip_train_step,
                  make_train_step, pack_messages, strategy_from_config,
                  unpack_duals)
from .async_epochs import make_async_gossip_train_step
from .consensus import (ConsensusStrategy, ExactConsensus, GossipConsensus,
                        QuantizedGossipConsensus, SurvivorTaps, Taps,
                        epoch_draws, group_taps, make_strategy,
                        masked_metropolis, survivor_taps)
from .pipeline import make_pipelined_gossip_train_step
from .redundancy import CodedAssignment, epoch_weights, seq_weights_from_b

__all__ = ["AMBConfig", "CodedAssignment", "ConsensusStrategy",
           "ExactConsensus", "GossipConsensus", "NoiseStats",
           "QuantizedGossipConsensus", "SurvivorTaps", "Taps",
           "assignment_from_config", "epoch_draws", "epoch_weights",
           "gossip_primal", "grad_noise_stats", "group_taps",
           "make_async_gossip_train_step", "make_gossip_train_step",
           "make_pipelined_gossip_train_step", "make_strategy",
           "make_train_step", "masked_metropolis", "pack_messages",
           "seq_weights_from_b", "strategy_from_config", "survivor_taps",
           "unpack_duals"]
