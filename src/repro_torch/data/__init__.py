"""The data plane: synthetic streams, input sources and the prefetcher."""
from .loader import (CostedSource, InputSource, Prefetcher, StreamSource,
                     SyntheticSource, local_rows, make_source, put_batch)
from .pipeline import (LinRegStream, LMTokenStream, LogRegStream,
                       make_stream, shard_batch)

__all__ = ["LMTokenStream", "LinRegStream", "LogRegStream", "make_stream",
           "shard_batch", "put_batch", "InputSource", "StreamSource",
           "SyntheticSource", "CostedSource", "Prefetcher", "local_rows",
           "make_source"]
