"""The Low-bit Module's share of its bandwidth bound: the bytes its calls in
the window need at the card's peak HBM bandwidth, over its kernels' device
time. A quantize reads each row's values (float32) and, when it rounds
stochastically, its noise (float32), and writes the packed codes and one
scale and zero per row; a dequantize reads those and writes the row."""


def _packed(d, bits):
    k = 8 // bits if bits in (1, 2, 4) else 1
    return -(-d // k)


def read(run):
    secs = run.device_seconds("lowbit")
    if not secs or run.peaks is None:
        return None
    total = 0
    for rows, d, bits, noise, sb in run.calls.quantize:
        total += rows * d * 4 * (2 if noise else 1)
        total += rows * (_packed(d, bits) + 2 * sb)
    for rows, d, bits, sb in run.calls.dequantize:
        total += rows * (_packed(d, bits) + 2 * sb) + rows * d * 4
    if not total:
        return None
    return 100.0 * total / run.peaks["hbm_bytes_per_s"] / secs
