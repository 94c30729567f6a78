"""Quantized full-graph serving: inference engine + k-hop delta refresh."""
from .engine import InferenceEngine, QueryResult, ServeComm, ServeConfig  # noqa: F401
