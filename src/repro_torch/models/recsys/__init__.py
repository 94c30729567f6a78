"""Recommendation models: DLRM."""
