"""Host-side data pipeline of the port: synthetic LM token batches and a
background prefetcher that keeps batches ready on the device
(``repro/data/pipeline.py``). ``criteo_stream`` waits for DLRM (ROADMAP
queue A, item 15)."""
from .pipeline import Prefetcher, token_stream

__all__ = ["Prefetcher", "token_stream"]
