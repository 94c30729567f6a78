"""The port's Low-bit Module against the JAX reference, on the CPU.

The same inputs — made with numpy from a seed, noise included — go through
``repro`` and ``repro_torch``:

* the fused kernel contract (``kernels/quant``): the port's plain version
  (what its wrapper runs on a CPU tensor) against the Pallas kernel in
  interpret mode — payload bit-exact, scale and zero exact in float32;
* ``core.quantization.quantize/dequantize`` for every width against
  ``repro.core.quantization`` with ``impl="jnp"`` — payload and the bf16
  scale/zero bit-exact, stochastic (the JAX draw passed in as ``u``) and
  deterministic.

Dequantized values are compared with ``atol 1e-6``: XLA may contract
``q * scale + zero`` into one FMA, while the port rounds the product first
(as its CUDA kernel does), so the two may differ in the last bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as jq
from repro.kernels.quant.quant import quantize_pack, unpack_dequantize
from repro_torch.core import quantization as tq
from repro_torch.kernels.quant import ops as tops

DEQ_ATOL = 1e-6


def _bits_of(x) -> np.ndarray:
    """Raw bits of a JAX or torch array (bf16 / f32 / uint8) as an integer
    numpy array, for bit-exact comparison."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        x = x.numpy()
    x = np.asarray(x)
    if x.dtype.itemsize == 2:
        return x.view(np.uint16)
    if x.dtype.itemsize == 4:
        return x.view(np.uint32)
    return x


def _inputs(rows, d, seed):
    rng = np.random.default_rng(seed)
    h = rng.normal(0, 1, (rows, d)).astype(np.float32)
    u = rng.random((rows, d), dtype=np.float32)
    return h, u


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("rows,d", [(7, 5), (300, 64), (257, 1433), (64, 288)])
def test_quantize_pack_matches_pallas_kernel(bits, rows, d):
    h, u = _inputs(rows, d, rows * d + bits)
    pj, sj, zj = quantize_pack(jnp.asarray(h), jnp.asarray(u), bits=bits,
                               interpret=True)
    pt, st, zt = tops.quantize_pack_rows(torch.from_numpy(h),
                                         torch.from_numpy(u), bits)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(_bits_of(st), _bits_of(sj))
    np.testing.assert_array_equal(_bits_of(zt), _bits_of(zj))
    oj = unpack_dequantize(pj, sj, zj, bits, d, interpret=True)
    ot = tops.dequantize_rows(pt, st, zt, bits, d)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0,
                               atol=DEQ_ATOL)


def test_quantize_pack_deterministic_rounds_half_to_even():
    """Deterministic rounding is round-half-to-even, like ``jnp.round``: a row
    built so that hbar lands exactly on .5 and 1.5 (bits=2, B=3)."""
    h = torch.tensor([[0.0, 0.5, 1.5, 3.0]]) / 3.0 * 3.0
    p, s, z = tops.quantize_pack_rows(h, None, 2)
    q = [(int(p[0, 0]) >> (2 * i)) & 3 for i in range(4)]
    assert q == [0, 0, 2, 3]
    jqt = jq.quantize(jnp.asarray(h.numpy()), 2, stochastic=False, impl="jnp")
    np.testing.assert_array_equal(p.numpy(), np.asarray(jqt.data))


def test_kernel_wrappers_reject_unpackable_widths():
    h, u = _inputs(4, 8, 0)
    with pytest.raises(ValueError):
        tops.quantize_pack_rows(torch.from_numpy(h), torch.from_numpy(u), 3)
    with pytest.raises(ValueError):
        tops.dequantize_rows(torch.zeros(4, 8, dtype=torch.uint8),
                             torch.ones(4), torch.zeros(4), 5, 8)


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 5, 6, 7, 8, 16, 32])
@pytest.mark.parametrize("stochastic", [True, False])
def test_core_quantize_matches_jax(bits, stochastic):
    shape = (4, 50, 64)            # leading dims, as the stacked send buffers
    rng = np.random.default_rng(bits * 7)
    h = (3.0 * rng.normal(0, 1, shape)).astype(np.float32)
    key = jax.random.PRNGKey(bits)
    qj = jq.quantize(jnp.asarray(h), bits, key, stochastic=stochastic,
                     impl="jnp")
    # the JAX path draws u = uniform(key, h.shape); hand the port that draw
    u = np.array(jax.random.uniform(key, shape, dtype=jnp.float32))
    qt = tq.quantize(torch.from_numpy(h), bits, stochastic=stochastic,
                     u=torch.from_numpy(u))
    assert (qt.bits, qt.feat_dim) == (qj.bits, qj.feat_dim)
    np.testing.assert_array_equal(_bits_of(qt.data), _bits_of(qj.data))
    np.testing.assert_array_equal(_bits_of(qt.scale), _bits_of(qj.scale))
    np.testing.assert_array_equal(_bits_of(qt.zero), _bits_of(qj.zero))
    assert tq.packed_width(shape[-1], bits) == jq.packed_width(shape[-1], bits)
    assert tq.comm_bytes(37, shape[-1], bits) == jq.comm_bytes(37, shape[-1],
                                                               bits)
    dj = jq.dequantize(qj, impl="jnp")
    dt = tq.dequantize(qt)
    assert tuple(dt.shape) == shape
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6,
                               atol=DEQ_ATOL)


def test_core_quantize_draws_from_generator():
    """Without ``u``, stochastic rounding draws from the caller's generator:
    the same seed gives the same payload, another seed another one."""
    h = torch.from_numpy(_inputs(64, 32, 3)[0])

    def q(seed):
        return tq.quantize(h, 1, torch.Generator().manual_seed(seed)).data

    assert torch.equal(q(1), q(1))
    assert not torch.equal(q(1), q(2))
    with pytest.raises(ValueError):
        tq.quantize(h, 1, stochastic=True)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("rows,d,constant", [(1, 1, False), (1, 33, False),
                                             (1, 4099, False), (7, 33, True)])
def test_quantize_pack_matches_pallas_kernel_at_edges(bits, rows, d, constant):
    """The edge shapes of the CUDA kernel's layout: one value, one value past
    a 32-lane chunk, a row longer than the values a lane keeps in registers,
    a single row, and constant rows (rng = 0, so scale = 0)."""
    h, u = _inputs(rows, d, 11 * d + bits)
    if constant:
        h[::2] = np.float32(0.37)
    pj, sj, zj = quantize_pack(jnp.asarray(h), jnp.asarray(u), bits=bits,
                               interpret=True)
    pt, st, zt = tops.quantize_pack_rows(torch.from_numpy(h),
                                         torch.from_numpy(u), bits)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(_bits_of(st), _bits_of(sj))
    np.testing.assert_array_equal(_bits_of(zt), _bits_of(zj))
    if constant:
        assert (st[::2] == 0).all() and (pt[::2] == 0).all()
    oj = unpack_dequantize(pj, sj, zj, bits, d, interpret=True)
    ot = tops.dequantize_rows(pt, st, zt, bits, d)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0,
                               atol=DEQ_ATOL)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("stochastic", [True, False])
def test_bf16_scale_path_equals_f32_path_cast(bits, stochastic):
    """The wrappers' bf16 scale/zero (what the CUDA kernel writes and reads
    directly) are the float32 ones rounded by ``.to(bfloat16)``, and dequantize
    from them as from their float32 widening."""
    h, u = _inputs(33, 75, 5 * bits + stochastic)
    ht = torch.from_numpy(h)
    ut = torch.from_numpy(u) if stochastic else None
    p32, s32, z32 = tops.quantize_pack_rows(ht, ut, bits)
    pb, sb, zb = tops.quantize_pack_rows(ht, ut, bits, torch.bfloat16)
    assert (sb.dtype, zb.dtype) == (torch.bfloat16, torch.bfloat16)
    assert torch.equal(pb, p32)
    np.testing.assert_array_equal(_bits_of(sb), _bits_of(s32.bfloat16()))
    np.testing.assert_array_equal(_bits_of(zb), _bits_of(z32.bfloat16()))
    assert torch.equal(tops.dequantize_rows(pb, sb, zb, bits, 75),
                       tops.dequantize_rows(p32, sb.float(), zb.float(),
                                            bits, 75))


@pytest.mark.parametrize("bits", [1, 8])
@pytest.mark.parametrize("scale_dtype", ["bfloat16", "float16"])
def test_core_scale_dtype_matches_jax(bits, scale_dtype):
    """``core.quantization`` hands the kernel wrappers the wire's scale dtype
    where they take it (bf16) and casts float32 where they do not (f16); both
    equal ``repro.core.quantization`` bit for bit."""
    shape = (3, 40, 33)
    h = np.random.default_rng(bits).normal(0, 2, shape).astype(np.float32)
    key = jax.random.PRNGKey(bits + 1)
    qj = jq.quantize(jnp.asarray(h), bits, key, scale_dtype=getattr(
        jnp, scale_dtype), impl="jnp")
    u = np.array(jax.random.uniform(key, shape, dtype=jnp.float32))
    qt = tq.quantize(torch.from_numpy(h), bits, u=torch.from_numpy(u),
                     scale_dtype=getattr(torch, scale_dtype))
    assert qt.scale.dtype == getattr(torch, scale_dtype)
    np.testing.assert_array_equal(_bits_of(qt.data), _bits_of(qj.data))
    np.testing.assert_array_equal(_bits_of(qt.scale), _bits_of(qj.scale))
    np.testing.assert_array_equal(_bits_of(qt.zero), _bits_of(qj.zero))
    np.testing.assert_allclose(tq.dequantize(qt).numpy(),
                               np.asarray(jq.dequantize(qj, impl="jnp")),
                               rtol=1e-6, atol=DEQ_ATOL)


def test_kernel_wrappers_reject_other_scale_dtypes():
    h = torch.from_numpy(_inputs(4, 8, 0)[0])
    with pytest.raises(ValueError):
        tops.quantize_pack_rows(h, None, 1, torch.float16)
    p, s, z = tops.quantize_pack_rows(h, None, 1, torch.bfloat16)
    with pytest.raises(ValueError):
        tops.dequantize_rows(p, s.half(), z.half(), 1, 8)
    with pytest.raises(ValueError):
        tops.dequantize_rows(p, s, z.float(), 1, 8)
