"""The public surface: specs, clocks, protocols and ``AMBSession``."""
from .clock import MeasuredClock, SimulatedClock, make_clock
from .protocol import ExactProtocol, GossipProtocol, build_protocol
from .session import AMBSession
from .specs import ClockSpec, ConsensusSpec, TrainSpec

__all__ = ["AMBSession", "ClockSpec", "ConsensusSpec", "ExactProtocol",
           "GossipProtocol", "MeasuredClock", "SimulatedClock", "TrainSpec",
           "build_protocol", "make_clock"]
