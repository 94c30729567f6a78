"""Planted RA107: an unused import."""
import os


def double(x):
    return 2 * x
