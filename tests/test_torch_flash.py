"""The port's flash-attention forward against the JAX reference, on the CPU.

The same numpy inputs go through the JAX package (the Pallas kernel in
interpret mode, as ``tests/test_kernels.py`` runs it, its dense oracle, and
the LM's ``blockwise_attention``) and through the port's wrappers, which run
their plain PyTorch versions on a CPU tensor. Tolerance ``rtol 2e-4,
atol 2e-5``, as ``tests/test_kernels.py`` holds the Pallas kernel to its
oracle: the two sum scores in different orders in float32.

The port's one deliberate difference: a query row that sees no key at all
comes out as 0 (masked scores contribute exactly 0), where the JAX functions
return a block-dependent mean of ``v``. Every row that sees a key agrees.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash.flash import flash_fwd as jax_flash_fwd
from repro.kernels.flash.ref import flash_ref as jax_flash_ref
from repro.models.lm import model as JLM
from repro_torch.kernels.flash import ops as F
from repro_torch.kernels.flash import ref as R

RTOL, ATOL = 2e-4, 2e-5


def _qkv(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, s).astype(np.float32) for s in shapes]


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 24),
                                           (False, None)])
@pytest.mark.parametrize("bh,s,d,blkq,blkk", [(2, 100, 64, 32, 32),
                                              (3, 96, 16, 32, 16)])
def test_flash_fwd_raw_matches_pallas_kernel(causal, window, bh, s, d, blkq,
                                             blkk):
    q, k, v = _qkv(s + d, (bh, s, d), (bh, s, d), (bh, s, d))
    kw = dict(blk_q=blkq, blk_k=blkk, causal=causal, scale=d**-0.5,
              window=window)
    acc_j, m_j, l_j = jax_flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), interpret=True, **kw)
    acc_t, m_t, l_t = F.flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), **kw)
    assert acc_t.dtype == m_t.dtype == l_t.dtype == torch.float32
    assert tuple(acc_t.shape) == (bh, s, d) and tuple(l_t.shape) == (bh, s)
    _close(acc_t, acc_j)
    _close(m_t, m_j)
    _close(l_t, l_j)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 9),
                                           (False, None), (False, 12)])
def test_flash_attention_matches_dense_oracle(causal, window):
    q, k, v = _qkv(7, (3, 80, 32), (3, 80, 32), (3, 80, 32))
    kw = dict(causal=causal, scale=32**-0.5, window=window)
    ref_j = jax_flash_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    out = F.flash_attention(qt, kt, vt, blk_q=32, blk_k=16, **kw)
    _close(out, ref_j)
    _close(F.flash_ref(qt, kt, vt, **kw), ref_j)


@pytest.mark.parametrize("blkq,blkk", [(80, 80), (16, 16), (40, 20),
                                       (64, 64)])
def test_flash_fwd_block_size_invariance(blkq, blkk):
    q, k, v = map(torch.from_numpy, _qkv(3, (2, 80, 32), (2, 80, 32),
                                         (2, 80, 32)))
    ref = F.flash_ref(q, k, v, scale=32**-0.5)
    out = F.flash_attention(q, k, v, blk_q=blkq, blk_k=blkk, scale=32**-0.5)
    _close(out, ref)


@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("block", [4, 16])
def test_attention_bshd_matches_blockwise_attention(window, softcap, block):
    b, s, h, hkv, d = 2, 33, 4, 2, 8
    q, k, v = _qkv(11, (b, s, h, d), (b, s, hkv, d), (b, s, hkv, d))
    kw = dict(causal=True, window=window, softcap=softcap, q_offset=0,
              kv_len=s, block=block, scale=d**-0.5)
    ref = JLM.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), **kw)
    out = F.attention_bshd(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), **kw)
    assert tuple(out.shape) == (b, s, h, d) and out.dtype == torch.float32
    _close(out, ref)


@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("softcap", [None, 30.0])
def test_attention_bshd_narrow_values_match_blockwise_attention(window,
                                                                softcap):
    """v narrower than q and k, as MLA's (q/k 24 = d_nope + d_rope, v 16 in
    deepseek-v2's reduced config), with GQA, the window and the softcap;
    scale 1 puts scores at several standard deviations, where the cap
    bends them."""
    b, s, h, hkv, d, dv = 2, 33, 4, 2, 24, 16
    q, k, v = _qkv(12, (b, s, h, d), (b, s, hkv, d), (b, s, hkv, dv))
    kw = dict(causal=True, window=window, softcap=softcap, q_offset=0,
              kv_len=s, block=8, scale=1.0)
    ref = JLM.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), **kw)
    out = F.attention_bshd(*map(torch.from_numpy, (q, k, v)), **kw)
    assert tuple(out.shape) == (b, s, h, dv) and out.dtype == torch.float32
    _close(out, ref)


def test_flash_fwd_takes_narrower_values():
    """The raw entry point and both plain versions with v of width 8 under
    q/k of width 24: ``flash_fwd``'s (acc, m, l) normalised against the JAX
    package's dense oracle (which takes any v width) and the port's."""
    q, k, v = _qkv(13, (3, 40, 24), (3, 40, 24), (3, 40, 8))
    kw = dict(causal=True, scale=0.3, window=11)
    acc, m, l = F.flash_fwd(*map(torch.from_numpy, (q, k, v)), blk_q=16,
                            blk_k=16, **kw)
    assert tuple(acc.shape) == (3, 40, 8) and tuple(l.shape) == (3, 40)
    dense = jax_flash_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          **kw)
    _close(acc / l[..., None], dense)
    _close(F.flash_ref(*map(torch.from_numpy, (q, k, v)), **kw), dense)


def test_attention_bshd_kv_len_masks_the_tail():
    b, s, h, hkv, d = 1, 20, 4, 1, 16
    q, k, v = _qkv(5, (b, s, h, d), (b, s, hkv, d), (b, s, hkv, d))
    kw = dict(causal=False, window=None, softcap=None, q_offset=0, kv_len=13,
              block=8, scale=0.25)
    ref = JLM.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), **kw)
    _close(F.attention_bshd(*map(torch.from_numpy, (q, k, v)), **kw), ref)


@pytest.mark.parametrize("window", [1, 5])
def test_window_smaller_than_a_tile(window):
    """A window of 5 inside 32-key blocks: most blocks a row meets are wholly
    masked while its running max is still NEG; nothing of them survives."""
    q, k, v = _qkv(window, (2, 70, 16), (2, 70, 16), (2, 70, 16))
    kw = dict(blk_q=32, blk_k=32, causal=True, scale=0.25, window=window)
    acc_j, m_j, l_j = jax_flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), interpret=True, **kw)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    acc_t, m_t, l_t = F.flash_fwd(qt, kt, vt, **kw)
    _close(acc_t, acc_j)
    _close(m_t, m_j)
    _close(l_t, l_j)
    dense = F.flash_ref(qt, kt, vt, causal=True, scale=0.25, window=window)
    _close(acc_t / l_t[..., None], dense)


def test_rows_that_see_no_key_come_out_zero():
    """q_offset -6: the first six rows see no key (causal). The port gives
    them 0; every other row equals the reference."""
    b, s, h, d = 1, 24, 2, 8
    q, k, v = _qkv(9, (b, s, h, d), (b, s, h, d), (b, s, h, d))
    kw = dict(causal=True, window=None, softcap=None, q_offset=-6, kv_len=s,
              block=8, scale=d**-0.5)
    ref = np.asarray(JLM.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v), **kw))
    out = F.attention_bshd(*map(torch.from_numpy, (q, k, v)), **kw).numpy()
    assert np.all(out[:, :6] == 0)
    _close(out[:, 6:], ref[:, 6:])


def test_flash_fwd_ref_takes_bfloat16_inputs_with_float32_math():
    q, k, v = _qkv(4, (2, 40, 16), (2, 40, 16), (2, 40, 16))
    qb, kb, vb = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    acc, m, l = F.flash_fwd(qb, kb, vb, blk_q=16, blk_k=16, scale=0.25)
    assert acc.dtype == torch.float32
    acc_j, m_j, l_j = jax_flash_fwd(jnp.asarray(qb.float().numpy(),
                                                jnp.bfloat16),
                                    jnp.asarray(kb.float().numpy(),
                                                jnp.bfloat16),
                                    jnp.asarray(vb.float().numpy(),
                                                jnp.bfloat16),
                                    blk_q=16, blk_k=16, scale=0.25,
                                    interpret=True)
    _close(acc, acc_j)
    _close(l, l_j)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_kernel_route_refuses_what_the_kernel_lacks():
    """Off the CPU the wrappers go to the kernel: they refuse a nonzero
    q_offset, non-float dtypes, wide heads, a v wider than q, a negative
    softcap, and any device that is not CUDA — they never fall back to the
    plain version. A softcap and a narrower v go to the kernel."""
    q, kv = _meta(1, 8, 4, 16), _meta(1, 8, 2, 16)
    base = dict(causal=True, window=None, softcap=None, q_offset=0, kv_len=8)
    with pytest.raises(NotImplementedError, match="q_offset"):
        F.attention_bshd(q, kv, kv, **{**base, "q_offset": 3})
    qi, kvi = (_meta(*t.shape, dtype=torch.int32) for t in (q, kv))
    with pytest.raises(TypeError):
        F.attention_bshd(qi, kvi, kvi, **base)
    with pytest.raises(ValueError, match="D <= 256"):
        F.attention_bshd(_meta(1, 8, 4, 320), _meta(1, 8, 2, 320),
                         _meta(1, 8, 2, 320), **base)
    with pytest.raises(ValueError, match="Dv <= D"):
        F.attention_bshd(q, kv, _meta(1, 8, 2, 32), **base)
    with pytest.raises(ValueError, match="softcap"):
        F.attention_bshd(q, kv, kv, **{**base, "softcap": -30.0})
    with pytest.raises(ValueError, match="CUDA"):
        F.attention_bshd(q, kv, kv, **base)
    with pytest.raises(ValueError, match="CUDA"):   # reaches the device check
        F.attention_bshd(q, kv, _meta(1, 8, 2, 8), **{**base,
                                                      "softcap": 30.0})
    with pytest.raises(ValueError, match="CUDA"):
        F.flash_fwd(_meta(2, 8, 16), _meta(2, 8, 16), _meta(2, 8, 16))
    with pytest.raises(TypeError):
        F.flash_fwd(*(_meta(2, 8, 16, dtype=torch.int64),) * 3)
    assert F.FLASH_FWD.launches == 0


def test_wrappers_check_shapes():
    x = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError):
        F.flash_fwd(x, torch.zeros(3, 8, 16), torch.zeros(3, 8, 16))
    with pytest.raises(ValueError):
        F.attention_bshd(torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 2, 16),
                         torch.zeros(1, 8, 2, 16), causal=True, window=None,
                         softcap=None, q_offset=0, kv_len=8)
