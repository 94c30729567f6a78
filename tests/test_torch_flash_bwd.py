"""The gradient of the port's LM attention against the JAX reference, on the
CPU.

The JAX package has no backward kernel: it differentiates
``repro.models.lm.model.blockwise_attention`` itself. The port's plain
backward, ``attention_bshd_bwd_ref`` (the explicit formulas over KV blocks,
the plain version of ``csrc/flash_bwd.cu``), is held to ``jax.vjp`` of it
and to torch autograd of the port's own forward ``attention_bshd_ref``, on
the same numpy inputs, over causal / window / softcap / GQA / Dv < D /
``kv_len`` with rows that see no key / S not a multiple of the KV block.

Tolerance: max |port - reference| <= 1e-5 x the largest magnitude of the
reference's gradient (``TOL``): float32 sums over the same blocks in
another order (measured: below 1e-6).

A row that sees no key comes out as 0 in the port (``ref.py``), where the
JAX function returns a block-dependent mean of ``v``; its gradient then
flows into ``v`` in JAX and nowhere in the port. Against JAX those rows'
output gradient is zeroed; the port's own behaviour for them (dq 0, nothing
added to dk or dv) is checked apart.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.lm import model as JLM
from repro_torch.kernels.flash import ops as F
from repro_torch.kernels.flash import ref as R

TOL = 1e-5

# (b, s, h, hkv, d, dv, window, softcap, kv_len, block, scale); kv_len None
# is s
CASES = {
    "causal": (2, 32, 4, 4, 16, 16, None, None, None, 8, 0.25),
    "window": (2, 32, 4, 4, 16, 16, 5, None, None, 8, 0.25),
    "softcap": (2, 32, 4, 4, 16, 16, None, 5.0, None, 8, 1.0),
    "gqa": (2, 32, 4, 2, 16, 16, None, None, None, 8, 0.25),
    "dv < d": (2, 32, 4, 4, 24, 16, None, None, None, 8, 0.3),
    "kv_len, rows that see no key": (2, 40, 4, 2, 16, 16, 5, None, 10, 8,
                                     0.25),
    "s not a block multiple": (2, 37, 4, 2, 16, 16, None, None, None, 8,
                               0.25),
    "all at once": (2, 37, 4, 2, 24, 16, 7, 5.0, 28, 8, 1.0),
}


def _inputs(case, seed=0):
    b, s, h, hkv, d, dv, window, cap, kv_len, block, scale = CASES[case]
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(0, 1, shape).astype(np.float32) for shape in (
        (b, s, h, d), (b, s, hkv, d), (b, s, hkv, dv), (b, s, h, dv)))
    kw = dict(causal=True, window=window, softcap=cap, q_offset=0,
              kv_len=s if kv_len is None else kv_len, block=block,
              scale=scale)
    return q, k, v, do, kw


def _no_key_rows(s, kw) -> np.ndarray:
    pos = torch.arange(s)
    seen = R._mask(pos, pos, causal=kw["causal"], window=kw["window"],
                   kv_len=kw["kv_len"])
    return (~seen.any(1)).numpy()


def _bwd_kw(kw):
    return {k: kw[k] for k in ("causal", "window", "softcap", "kv_len",
                               "scale", "block")}


def _plain_bwd(q, k, v, do, kw):
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    out, lse = R.attention_bshd_ref(qt, kt, vt, **kw, return_lse=True)
    return R.attention_bshd_bwd_ref(qt, kt, vt, out, lse,
                                    torch.from_numpy(do), **_bwd_kw(kw))


def _close(got, want, what):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    top = float(np.abs(want).max())
    assert err <= TOL * top, f"{what}: max abs err {err}, largest {top}"


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_jax_vjp_of_blockwise_attention(case):
    q, k, v, do, kw = _inputs(case)
    do[:, _no_key_rows(q.shape[1], kw)] = 0.0
    _, vjp = jax.vjp(lambda a, b_, c: JLM.blockwise_attention(a, b_, c, **kw),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    got = _plain_bwd(q, k, v, do, kw)
    for name, g, w, x in zip("qkv", got, want, (q, k, v)):
        assert g.dtype == torch.float32 and tuple(g.shape) == x.shape
        _close(g, w, f"{case}: d{name}")


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_torch_autograd(case):
    q, k, v, do, kw = _inputs(case, seed=1)
    qa, ka, va = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = R.attention_bshd_ref(qa, ka, va, **kw)
    want = torch.autograd.grad(out, (qa, ka, va), torch.from_numpy(do))
    got = _plain_bwd(q, k, v, do, kw)
    for name, g, w in zip("qkv", got, want):
        _close(g, w, f"{case}: d{name}")


def test_rows_that_see_no_key_get_no_gradient():
    """kv_len 10, window 5: rows 14 and on see no key. Their dq is exactly
    0 and their output gradient adds nothing to dk or dv, bit for bit."""
    case = "kv_len, rows that see no key"
    q, k, v, do, kw = _inputs(case)
    rows = _no_key_rows(q.shape[1], kw)
    assert rows.sum() == q.shape[1] - 14 and not rows[:14].any()
    dq, dk, dv = _plain_bwd(q, k, v, do, kw)
    assert torch.all(dq[:, torch.from_numpy(rows)] == 0)
    assert torch.all(dk[:, 10:] == 0) and torch.all(dv[:, 10:] == 0)
    do0 = do.copy()
    do0[:, rows] = 0.0
    _, dk0, dv0 = _plain_bwd(q, k, v, do0, kw)
    assert torch.equal(dk, dk0) and torch.equal(dv, dv0)


def test_lse_is_each_rows_log_sum_exp():
    q, k, v, _, kw = _inputs("all at once")
    out, lse = R.attention_bshd_ref(*map(torch.from_numpy, (q, k, v)), **kw,
                                    return_lse=True)
    b, s, h, _ = q.shape
    g = h // k.shape[2]
    scores = np.einsum("bqhd,bkhd->bhqk", q * kw["scale"],
                       np.repeat(k, g, axis=2)).astype(np.float64)
    cap = kw["softcap"]
    scores = cap * np.tanh(scores / cap)
    pos = torch.arange(s)
    seen = R._mask(pos, pos, causal=True, window=kw["window"],
                   kv_len=kw["kv_len"]).numpy()
    with np.errstate(divide="ignore"):
        want = np.log(np.where(seen, np.exp(scores), 0.0).sum(-1))
    want = want.reshape(b * h, s)
    got = lse.numpy()
    none = ~seen.any(1)
    assert none.any() and np.all(np.isneginf(got.reshape(b, h, s)[..., none]))
    np.testing.assert_allclose(got.reshape(b, h, s)[..., ~none],
                               want.reshape(b, h, s)[..., ~none], rtol=1e-6,
                               atol=1e-6)


def test_flash_attention_routes_a_cpu_tensor_to_the_plain_backward(
        monkeypatch):
    """``attention_bshd`` with inputs that require grad goes through
    ``FlashAttention``; on the CPU its forward is the plain version and its
    backward ``attention_bshd_bwd_ref`` (called once, and its result is the
    gradient), and no kernel launches. Without grad it is the plain forward
    as before."""
    q, k, v, do, kw = _inputs("all at once", seed=2)
    calls = []
    real = R.attention_bshd_bwd_ref

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)
    monkeypatch.setattr(R, "attention_bshd_bwd_ref", counted)
    launches = (F.FLASH_FWD.launches, F.FLASH_BWD_DQ.launches,
                F.FLASH_BWD_DKDV.launches)
    qa, ka, va = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = F.attention_bshd(qa, ka, va, **kw)
    assert out.grad_fn is not None and "FlashAttention" in out.grad_fn.name()
    plain = F.attention_bshd(*map(torch.from_numpy, (q, k, v)), **kw)
    assert plain.grad_fn is None and torch.equal(out.detach(), plain)
    got = torch.autograd.grad(out, (qa, ka, va), torch.from_numpy(do))
    assert len(calls) == 1
    want = _plain_bwd(q, k, v, do, kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (F.FLASH_FWD.launches, F.FLASH_BWD_DQ.launches,
            F.FLASH_BWD_DKDV.launches) == launches


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_backward_kernel_route_refuses_what_the_kernels_lack():
    """Off the CPU the backward goes to the kernels: it refuses bfloat16
    (the kernels are float32 only), D > 256, Dv > D and any device that is
    not CUDA, and never falls back to the plain version; a gradient at
    q_offset != 0 is refused on any device."""
    b, s, h, hkv, d = 1, 8, 4, 2, 16
    kw = dict(causal=True, window=None, softcap=None, kv_len=s)

    def call(d=d, dv=d, dtype=torch.float32):
        q, k, v = (_meta(b, s, h, d, dtype=dtype), _meta(b, s, hkv, d,
                                                          dtype=dtype),
                   _meta(b, s, hkv, dv, dtype=dtype))
        out = _meta(b, s, h, dv, dtype=dtype)
        return F.attention_bshd_bwd(q, k, v, out, _meta(b * h, s), out, **kw)
    with pytest.raises(TypeError, match="float32"):
        call(dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="D <= 256"):
        call(d=320, dv=320)
    with pytest.raises(ValueError, match="Dv <= D"):
        call(dv=32)
    with pytest.raises(ValueError, match="CUDA"):
        call()
    with pytest.raises(ValueError, match="CUDA"):     # MLA's widths pass
        call(d=192, dv=128)
    assert F.FLASH_BWD_DQ.launches == F.FLASH_BWD_DKDV.launches == 0
    q = torch.zeros(b, s, h, d, requires_grad=True)
    kv = torch.zeros(b, s, hkv, d)
    with pytest.raises(NotImplementedError, match="q_offset"):
        F.attention_bshd(q, kv, kv, causal=True, window=None, softcap=None,
                         q_offset=2, kv_len=s)


def _tf32(x: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32``: float32 rounded to 10 mantissa bits, to nearest
    with ties away from zero (the low 13 bits cleared)."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _product(a: np.ndarray, b: np.ndarray, scheme: str) -> np.ndarray:
    """a @ b as the kernels' tensor cores take it, float32 accumulation: in
    3xTF32 each operand is split into big = tf32(x) and small = tf32(x -
    big) and small*big + big*small + big*big are summed; in 1xTF32 only
    big*big."""
    a, b = a.astype(np.float32), b.astype(np.float32)
    a_big, b_big = _tf32(a), _tf32(b)
    out = a_big @ b_big
    if scheme == "3xtf32":
        out = _tf32(a - a_big) @ b_big + a_big @ _tf32(b - b_big) + out
    return out


@pytest.mark.parametrize("scheme", ["3xtf32", "1xtf32"])
@pytest.mark.parametrize("widths", [(64, 64, 512), (192, 128, 256)],
                         ids=["d 64", "d 192, dv 128"])
def test_tensor_core_precision_scheme_holds_the_kernel_gate(widths, scheme):
    """The products of ``csrc/flash_bwd.cu`` run on the tensor cores in
    3xTF32. With every product of the backward's formulas (S, dP, dQ, dK, dV)
    taken that way, dq, dk and dv stay within a tenth of the card's gate
    (``chip_smoke.FLASH_BWD_TOL`` x the largest) of float64, at B 1, H 2,
    causal; with one TF32 product (big*big alone) at least one misses the
    gate. The forward's O and lse are float64's."""
    import chip_smoke
    tol = chip_smoke.FLASH_BWD_TOL
    d, dv, s = widths
    scale = d ** -0.5
    rng = np.random.default_rng(7)
    q, k = (rng.normal(0, 1, (2, s, d)) for _ in range(2))
    v, do = (rng.normal(0, 1, (2, s, dv)) for _ in range(2))
    seen = np.tril(np.ones((s, s), dtype=bool))
    sc = np.where(seen, scale * q @ k.transpose(0, 2, 1), -np.inf)
    lse = np.log(np.exp(sc - sc.max(-1, keepdims=True)).sum(-1)) \
        + sc.max(-1)
    p64 = np.exp(sc - lse[..., None])
    o = p64 @ v
    delta = (do * o).sum(-1, keepdims=True)

    def grads(mm):
        tr = (0, 2, 1)
        sc_ = np.where(seen, scale * mm(q, k.transpose(tr)), -np.inf)
        p = np.exp(sc_ - lse[..., None])
        ds = p * (mm(do, v.transpose(tr)) - delta)
        return (scale * mm(ds, k), scale * mm(ds.transpose(tr), q),
                mm(p.transpose(tr), do))
    want = grads(np.matmul)
    got = grads(lambda a, b: _product(a, b, scheme).astype(np.float64))
    errs = [float(np.abs(g - w).max() / np.abs(w).max())
            for g, w in zip(got, want)]
    if scheme == "3xtf32":
        assert max(errs) <= tol / 10, errs
    else:
        assert max(errs) > tol, errs
