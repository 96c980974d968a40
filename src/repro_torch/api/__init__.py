"""The public surface: specs, clocks, protocols and ``AMBSession``."""
from .clock import Clock, MeasuredClock, SimulatedClock, make_clock
from .protocol import (AsyncProtocol, ExactProtocol, GossipProtocol,
                       PipelinedProtocol, TrainProtocol, build_protocol)
from .session import AMBSession
from .specs import ClockSpec, ConsensusSpec, ControllerSpec, TrainSpec

__all__ = ["AMBSession", "AsyncProtocol", "Clock", "ClockSpec",
           "ConsensusSpec", "ControllerSpec", "ExactProtocol",
           "GossipProtocol", "MeasuredClock", "PipelinedProtocol",
           "SimulatedClock", "TrainProtocol", "TrainSpec", "build_protocol",
           "make_clock"]
