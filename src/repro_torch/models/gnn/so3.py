r"""Real spherical harmonics and the equivariant bilinear (Gaunt) tensors,
l <= 2, as ``repro.models.gnn.so3`` computes them.

NequIP needs, per edge, the tensor product (node irreps) x (edge SH)
projected onto output irreps. For each triple (l1, l2, l3) the space of
equivariant bilinear maps l1 (x) l2 -> l3 is one-dimensional; its basis
tensor is taken numerically as the *Gaunt coefficients*

    C[m1, m2, m3] = \int  Y_{l1 m1}  Y_{l2 m2}  Y_{l3 m3}  dOmega,

evaluated exactly by a Gauss-Legendre x uniform-phi product quadrature (the
integrand is a spherical polynomial of degree <= 6 for l <= 2), then
normalized to unit Frobenius norm. The numpy functions are the reference's
code, so they give its bits; :func:`real_sh` is the same polynomial in
torch (the model's edge geometry is computed on the host with
:func:`real_sh_np`). :func:`wigner_d_numeric` gives the rotation matrices
the equivariance tests turn irreps by.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

# orthonormal real spherical harmonics (Condon-Shortley-free real convention)
_C0 = 0.28209479177387814          # 1/sqrt(4 pi)
_C1 = 0.4886025119029199           # sqrt(3/(4 pi))
_C2A = 1.0925484305920792          # sqrt(15/(4 pi))
_C2B = 0.31539156525252005         # sqrt(5/(16 pi))
_C2C = 0.5462742152960396          # sqrt(15/(16 pi))


def real_sh_np(vec: np.ndarray, l_max: int = 2) -> np.ndarray:
    """Real SH of *unit* vectors. vec: (..., 3) -> (..., (l_max+1)^2).
    Order: [Y00 | Y1,-1 Y1,0 Y1,1 | Y2,-2 .. Y2,2] with (x,y,z) components."""
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    out = [np.full(x.shape, _C0)]
    if l_max >= 1:
        out += [_C1 * y, _C1 * z, _C1 * x]
    if l_max >= 2:
        out += [_C2A * x * y, _C2A * y * z, _C2B * (3 * z ** 2 - 1),
                _C2A * x * z, _C2C * (x ** 2 - y ** 2)]
    return np.stack(out, axis=-1)


def real_sh(vec: torch.Tensor, l_max: int = 2) -> torch.Tensor:
    """:func:`real_sh_np` in torch (``vec``'s dtype and device)."""
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    out = [torch.full_like(x, _C0)]
    if l_max >= 1:
        out += [_C1 * y, _C1 * z, _C1 * x]
    if l_max >= 2:
        out += [_C2A * x * y, _C2A * y * z, _C2B * (3 * z ** 2 - 1),
                _C2A * x * z, _C2C * (x ** 2 - y ** 2)]
    return torch.stack(out, dim=-1)


def sh_slice(l: int) -> slice:
    return slice(l * l, (l + 1) * (l + 1))


@lru_cache(maxsize=None)
def _quad_points(n_theta: int = 12, n_phi: int = 25):
    ct, wt = np.polynomial.legendre.leggauss(n_theta)   # cos(theta) nodes
    phi = 2 * np.pi * np.arange(n_phi) / n_phi
    wphi = 2 * np.pi / n_phi
    st = np.sqrt(1 - ct ** 2)
    x = st[:, None] * np.cos(phi)[None, :]
    y = st[:, None] * np.sin(phi)[None, :]
    z = np.broadcast_to(ct[:, None], x.shape)
    w = np.broadcast_to(wt[:, None] * wphi, x.shape)
    pts = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    return pts, w.reshape(-1).copy()


@lru_cache(maxsize=None)
def gaunt(l1: int, l2: int, l3: int) -> np.ndarray | None:
    """Unit-Frobenius equivariant bilinear tensor (2l1+1, 2l2+1, 2l3+1), or None
    if the triple is not coupled (selection rules / vanishing integral)."""
    if not (abs(l1 - l2) <= l3 <= l1 + l2) or (l1 + l2 + l3) % 2 == 1:
        return None
    pts, w = _quad_points()
    sh = real_sh_np(pts, max(l1, l2, l3))
    y1 = sh[:, sh_slice(l1)]
    y2 = sh[:, sh_slice(l2)]
    y3 = sh[:, sh_slice(l3)]
    c = np.einsum("q,qa,qb,qc->abc", w, y1, y2, y3)
    norm = np.linalg.norm(c)
    if norm < 1e-10:
        return None
    return (c / norm).astype(np.float32)


def coupled_paths(l_in: tuple[int, ...], l_sh: tuple[int, ...],
                  l_out: tuple[int, ...]) -> list[tuple[int, int, int]]:
    """All (l1, l2, l3) triples with a nonzero Gaunt tensor."""
    out = []
    for a in l_in:
        for b in l_sh:
            for c in l_out:
                if gaunt(a, b, c) is not None:
                    out.append((a, b, c))
    return out


def wigner_d_numeric(rot: np.ndarray, l: int) -> np.ndarray:
    """(2l+1, 2l+1) real Wigner-D of rotation matrix ``rot`` via least squares over
    sample directions: Y_l(R r) = D_l(R) Y_l(r). Test-only utility."""
    rng = np.random.default_rng(0)
    v = rng.normal(size=(max(64, 4 * (2 * l + 1) ** 2), 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    a = real_sh_np(v, l)[:, sh_slice(l)]
    b = real_sh_np(v @ rot.T, l)[:, sh_slice(l)]
    d, *_ = np.linalg.lstsq(a, b, rcond=None)
    return d.T
