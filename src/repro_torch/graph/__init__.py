"""Host-side graphs: containers, synthetic generators, partitioner + halo plans.

numpy only. Kept in step with ``repro.graph`` so both packages partition a
graph into the same arrays (``tests/test_torch_exchange.py`` checks it).
"""
