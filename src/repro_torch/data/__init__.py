"""The data plane (on-device synthetic source so far)."""
from .loader import InputSource, SyntheticSource

__all__ = ["InputSource", "SyntheticSource"]
