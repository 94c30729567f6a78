"""Real spherical harmonics of unit vectors, l <= 2 (numpy, host-side), as
``repro.models.gnn.so3.real_sh_np``: the edge geometry of
:func:`repro_torch.models.gnn.blocks.geometry_edge_attr`."""
from __future__ import annotations

import numpy as np

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
