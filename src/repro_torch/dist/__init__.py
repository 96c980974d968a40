"""The AMB train steps and consensus strategies (worker dim on one device)."""
from .amb import (AMBConfig, gossip_primal, make_gossip_train_step,
                  make_train_step, pack_messages, seq_weights_from_b,
                  unpack_duals)
from .consensus import (ExactConsensus, GossipConsensus,
                        QuantizedGossipConsensus, Taps, epoch_draws,
                        group_taps, make_strategy)

__all__ = ["AMBConfig", "ExactConsensus", "GossipConsensus",
           "QuantizedGossipConsensus", "Taps", "epoch_draws",
           "gossip_primal", "group_taps", "make_gossip_train_step",
           "make_strategy", "make_train_step", "pack_messages",
           "seq_weights_from_b", "unpack_duals"]
