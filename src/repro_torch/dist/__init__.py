"""The AMB train steps and consensus strategies (worker dim on one device):
the sequential steps (:mod:`.amb`), the staleness-1 pipelined epochs
(:mod:`.pipeline`), the AMB-DG bounded-staleness epochs
(:mod:`.async_epochs`), and the strategies with their elastic survivor
relayout (:mod:`.consensus`)."""
from .amb import (AMBConfig, gossip_primal, make_gossip_train_step,
                  make_train_step, pack_messages, seq_weights_from_b,
                  strategy_from_config, unpack_duals)
from .async_epochs import make_async_gossip_train_step
from .consensus import (ConsensusStrategy, ExactConsensus, GossipConsensus,
                        QuantizedGossipConsensus, SurvivorTaps, Taps,
                        epoch_draws, group_taps, make_strategy,
                        masked_metropolis, survivor_taps)
from .pipeline import make_pipelined_gossip_train_step

__all__ = ["AMBConfig", "ConsensusStrategy", "ExactConsensus",
           "GossipConsensus", "QuantizedGossipConsensus", "SurvivorTaps",
           "Taps", "epoch_draws", "gossip_primal", "group_taps",
           "make_async_gossip_train_step", "make_gossip_train_step",
           "make_pipelined_gossip_train_step", "make_strategy",
           "make_train_step", "masked_metropolis", "pack_messages",
           "seq_weights_from_b", "strategy_from_config", "survivor_taps",
           "unpack_duals"]
