"""Host-side data pipeline of the port: synthetic LM token batches, the
synthetic Criteo stream of DLRM, and a background prefetcher that keeps
batches ready on the device (``repro/data/pipeline.py``)."""
from .pipeline import Prefetcher, criteo_stream, token_stream

__all__ = ["Prefetcher", "criteo_stream", "token_stream"]
