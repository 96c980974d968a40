"""The AMB train steps and consensus strategies: the sequential steps
(:mod:`.amb`; every worker on one device, or one process per worker over
a :class:`.group.WorkerGroup`), the staleness-1 pipelined epochs
(:mod:`.pipeline`), the AMB-DG bounded-staleness epochs
(:mod:`.async_epochs`), the strategies with their elastic survivor
relayout (:mod:`.consensus`), coded placement (:mod:`.redundancy`), and
the parameter layout and sharding context of a mesh (:mod:`.params`,
:mod:`.sharding`), re-exported as ``repro.dist`` re-exports them."""
from .amb import (AMBConfig, NoiseStats, assignment_from_config,
                  gossip_primal, grad_noise_stats, make_gossip_train_step,
                  make_train_step, pack_messages, ring_gossip,
                  strategy_from_config, unpack_duals)
from .async_epochs import make_async_gossip_train_step
from .consensus import (ConsensusStrategy, ExactConsensus, GossipConsensus,
                        QuantizedGossipConsensus, SurvivorTaps, Taps,
                        epoch_draws, group_taps, make_strategy,
                        masked_metropolis, survivor_taps,
                        torus_shape_for_mesh)
from .group import WorkerGroup, num_workers, worker_axes
from .params import param_spec, tree_shardings
from .pipeline import make_pipelined_gossip_train_step
from .redundancy import CodedAssignment, epoch_weights, seq_weights_from_b
from .sharding import active_mesh, constrain, use_sharding

__all__ = ["AMBConfig", "CodedAssignment", "ConsensusStrategy",
           "ExactConsensus", "GossipConsensus", "NoiseStats",
           "QuantizedGossipConsensus", "SurvivorTaps", "Taps",
           "WorkerGroup", "active_mesh", "assignment_from_config",
           "constrain", "epoch_draws", "epoch_weights", "gossip_primal",
           "grad_noise_stats", "group_taps",
           "make_async_gossip_train_step", "make_gossip_train_step",
           "make_pipelined_gossip_train_step", "make_strategy",
           "make_train_step", "masked_metropolis", "num_workers",
           "pack_messages", "param_spec", "ring_gossip",
           "seq_weights_from_b", "strategy_from_config", "survivor_taps",
           "torus_shape_for_mesh", "tree_shardings", "unpack_duals",
           "use_sharding", "worker_axes"]
