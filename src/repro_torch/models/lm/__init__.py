"""Transformer LM: configs, the model as functions over a parameter dict, and
weight conversion to and from the JAX package's parameter tree."""
