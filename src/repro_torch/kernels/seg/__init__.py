"""CSR segment max with tie counts: PNA's max and min (``csrc/seg.cu``)."""
