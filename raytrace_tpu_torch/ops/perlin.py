"""Classic Perlin noise and turbulence (raytrace_tpu/ops/perlin.py: the
public stegu/webgl-noise ``cnoise`` the reference's perlin.glsl uses).

The ``noise`` texture's marble pattern (ray_gen.glsl:203-208) reads
``turbulence_v3`` at the hit point.  Every function keeps the JAX
package's expression trees operation for operation, in float32: ``%`` is
``torch.remainder`` (a floor-mod, as JAX's), and the Python constants
``1.0 / 289.0``, ``1.0 / 7.0`` and the Taylor coefficients round to f32
where they meet a tensor, as JAX's weak types do.  The lattice hash
(``_permute`` chains) works on integer-valued floats below 2^24, so it is
exact; the gradients, fade and mixes round once per operation (PyTorch
contracts no multiply-add, XLA's CPU build does, so the two packages part
in the last bits there).

Two forms compute the same values: the component forms ``cnoise_v3`` and
``turbulence_v3`` (separate x, y, z tensors; the wavefront, the fused
kernel's plain version and csrc/megakernel.cu follow them), and the
stacked row forms ``cnoise`` and ``turbulence`` on [..., 3] tensors, whose
dot products sum their three products in index order, so the two forms
give the same bits.
"""

from __future__ import annotations

import torch


def _mod289(x):
    return x - torch.floor(x * (1.0 / 289.0)) * 289.0


def _permute(x):
    return _mod289(((x * 34.0) + 10.0) * x)


def _taylor_inv_sqrt(r):
    return 1.79284291400159 - 0.85373472095314 * r


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def _mix(a, b, t):
    return a + (b - a) * t


def _grads(v):
    """The gradient of a hashed lattice corner (perlin.py:133-141)."""
    gx = v * (1.0 / 7.0)
    gy = torch.remainder(torch.floor(gx) * (1.0 / 7.0), 1.0) - 0.5
    gx = torch.remainder(gx, 1.0)
    gz = 0.5 - torch.abs(gx) - torch.abs(gy)
    sz = torch.where(gz <= 0.0, 1.0, 0.0)  # step(gz, 0)
    gx = gx - sz * (torch.where(gx >= 0.0, 1.0, 0.0) - 0.5)
    gy = gy - sz * (torch.where(gy >= 0.0, 1.0, 0.0) - 0.5)
    return gx, gy, gz


def cnoise_v3(px, py, pz):
    """Classic Perlin noise on separate component tensors
    (raytrace_tpu/ops/perlin.py:124-167)."""
    fpx, fpy, fpz = torch.floor(px), torch.floor(py), torch.floor(pz)
    x0i, y0i, z0i = _mod289(fpx), _mod289(fpy), _mod289(fpz)
    x1i, y1i, z1i = (_mod289(fpx + 1.0), _mod289(fpy + 1.0),
                     _mod289(fpz + 1.0))
    x0, y0, z0 = px - fpx, py - fpy, pz - fpz
    x1, y1, z1 = x0 - 1.0, y0 - 1.0, z0 - 1.0

    # corner order matches cnoise's lanes: (x0,y0) (x1,y0) (x0,y1) (x1,y1)
    corners = [(x0i, y0i), (x1i, y0i), (x0i, y1i), (x1i, y1i)]
    n = {}
    for idx, (cx, cy) in enumerate(corners):
        ixy = _permute(_permute(cx) + cy)
        xx = x1 if idx in (1, 3) else x0
        yy = y1 if idx in (2, 3) else y0
        for czi, cz, tag in ((z0i, z0, "0"), (z1i, z1, "1")):
            gx, gy, gz = _grads(_permute(ixy + czi))
            norm = _taylor_inv_sqrt(gx * gx + gy * gy + gz * gz)
            gx, gy, gz = gx * norm, gy * norm, gz * norm
            key = (("1" if idx in (1, 3) else "0")
                   + ("1" if idx in (2, 3) else "0") + tag)
            n[key] = gx * xx + gy * yy + gz * cz

    fx, fy, fz = _fade(x0), _fade(y0), _fade(z0)
    nz00 = _mix(n["000"], n["001"], fz)
    nz10 = _mix(n["100"], n["101"], fz)
    nz01 = _mix(n["010"], n["011"], fz)
    nz11 = _mix(n["110"], n["111"], fz)
    ny0 = _mix(nz00, nz01, fy)
    ny1 = _mix(nz10, nz11, fy)
    return 2.2 * _mix(ny0, ny1, fx)


def turbulence_v3(px, py, pz, depth: int = 7):
    """Component-wise turbulence (perlin.glsl:147-159): the absolute sum
    of ``depth`` octaves of ``cnoise_v3``, each at twice the frequency and
    half the weight of the last."""
    accum = torch.zeros_like(px)
    weight = 1.0
    for _ in range(depth):
        accum = accum + weight * cnoise_v3(px, py, pz)
        weight *= 0.5
        px, py, pz = px * 2.0, py * 2.0, pz * 2.0
    return torch.abs(accum)


def _dot(a, b):
    """Sum of the three products in index order (JAX's jnp.sum over the
    last axis; written out so that the row forms give cnoise_v3's bits)."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def cnoise(p):
    """Classic Perlin noise on stacked points: p [..., 3] -> [...]
    (raytrace_tpu/ops/perlin.py:29-101)."""
    pi0 = torch.floor(p)
    pi1 = pi0 + 1.0
    pi0 = _mod289(pi0)
    pi1 = _mod289(pi1)
    pf0 = p - torch.floor(p)
    pf1 = pf0 - 1.0

    ix = torch.stack([pi0[..., 0], pi1[..., 0], pi0[..., 0], pi1[..., 0]], -1)
    iy = torch.stack([pi0[..., 1], pi0[..., 1], pi1[..., 1], pi1[..., 1]], -1)
    iz0 = pi0[..., 2:3]
    iz1 = pi1[..., 2:3]

    ixy = _permute(_permute(ix) + iy)
    gx0, gy0, gz0 = _grads(_permute(ixy + iz0))
    gx1, gy1, gz1 = _grads(_permute(ixy + iz1))

    def g(gx, gy, gz, i):
        return torch.stack([gx[..., i], gy[..., i], gz[..., i]], -1)

    g000, g100, g010, g110 = (g(gx0, gy0, gz0, i) for i in range(4))
    g001, g101, g011, g111 = (g(gx1, gy1, gz1, i) for i in range(4))

    norm0 = _taylor_inv_sqrt(torch.stack(
        [_dot(g000, g000), _dot(g010, g010), _dot(g100, g100),
         _dot(g110, g110)], -1))
    norm1 = _taylor_inv_sqrt(torch.stack(
        [_dot(g001, g001), _dot(g011, g011), _dot(g101, g101),
         _dot(g111, g111)], -1))
    g000 = g000 * norm0[..., 0:1]
    g010 = g010 * norm0[..., 1:2]
    g100 = g100 * norm0[..., 2:3]
    g110 = g110 * norm0[..., 3:4]
    g001 = g001 * norm1[..., 0:1]
    g011 = g011 * norm1[..., 1:2]
    g101 = g101 * norm1[..., 2:3]
    g111 = g111 * norm1[..., 3:4]

    x0, y0, z0 = pf0[..., 0], pf0[..., 1], pf0[..., 2]
    x1, y1, z1 = pf1[..., 0], pf1[..., 1], pf1[..., 2]

    def v3(a, b, c):
        return torch.stack([a, b, c], -1)

    n000 = _dot(g000, pf0)
    n010 = _dot(g010, v3(x0, y1, z0))
    n100 = _dot(g100, v3(x1, y0, z0))
    n110 = _dot(g110, v3(x1, y1, z0))
    n001 = _dot(g001, v3(x0, y0, z1))
    n011 = _dot(g011, v3(x0, y1, z1))
    n101 = _dot(g101, v3(x1, y0, z1))
    n111 = _dot(g111, v3(x1, y1, z1))

    fade = _fade(pf0)
    fx, fy, fz = fade[..., 0], fade[..., 1], fade[..., 2]
    nz00 = _mix(n000, n001, fz)
    nz10 = _mix(n100, n101, fz)
    nz01 = _mix(n010, n011, fz)
    nz11 = _mix(n110, n111, fz)
    ny0 = _mix(nz00, nz01, fy)
    ny1 = _mix(nz10, nz11, fy)
    return 2.2 * _mix(ny0, ny1, fx)


def turbulence(p, depth: int = 7):
    """7-octave |sum of halving-weight cnoise| on stacked points
    (raytrace_tpu/ops/perlin.py:104-113)."""
    accum = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    weight = 1.0
    q = p
    for _ in range(depth):
        accum = accum + weight * cnoise(q)
        weight *= 0.5
        q = q * 2.0
    return torch.abs(accum)


# ---- the fused kernel's noise design, in plain PyTorch ----
#
# csrc/megakernel.cu reads the hash chain's permutes from a table over
# [-1, 577] and each corner's scaled gradient from a table indexed by the
# argument of its last permute (gradient(permute(x))), both staged in
# shared memory, wherever an octave's lattice coordinates are below 2^24 in
# magnitude (there the chain is exact integer arithmetic on floats, so the
# tables hold every value it can produce), and computes them elsewhere
# (cnoise_table).  The tests hold the models to cnoise_v3 and
# turbulence_v3 bit for bit; nothing on a card path uses them.

TABLE_LIMIT = 2.0 ** 24
PERM_MIN, PERM_MAX = -1, 577   # the arguments the tables cover
OCTAVES = 7


def _fract(x):
    """torch.remainder(x, 1.0) as the kernel's gradient takes it: exact
    for x >= 0, elsewhere equal but for the sign of a zero."""
    return x - torch.floor(x)


def _scaled_grads(v):
    """[..., 3]: the gradient of hash ``v`` (_grads, with _fract for the
    remainder: the kernel's gradient()) scaled by _taylor_inv_sqrt of its
    squared length, as cnoise_v3 scales it."""
    gx = v * (1.0 / 7.0)
    gy = _fract(torch.floor(gx) * (1.0 / 7.0)) - 0.5
    gx = _fract(gx)
    gz = 0.5 - torch.abs(gx) - torch.abs(gy)
    sz = torch.where(gz <= 0.0, 1.0, 0.0)
    gx = gx - sz * (torch.where(gx >= 0.0, 1.0, 0.0) - 0.5)
    gy = gy - sz * (torch.where(gy >= 0.0, 1.0, 0.0) - 0.5)
    norm = _taylor_inv_sqrt(gx * gx + gy * gy + gz * gz)
    return torch.stack([gx * norm, gy * norm, gz * norm], -1)


def permute_table() -> torch.Tensor:
    """[PERM_MAX - PERM_MIN + 1] int64: _permute(x) of each integer x in
    [PERM_MIN, PERM_MAX], at x - PERM_MIN (the kernel's permute table)."""
    x = torch.arange(PERM_MIN, PERM_MAX + 1, dtype=torch.float32)
    return _permute(x).to(torch.int64)


def gradient_table() -> torch.Tensor:
    """[PERM_MAX - PERM_MIN + 1, 3] float32: the scaled gradient of the hash
    _permute(x) of each integer x in [PERM_MIN, PERM_MAX], at x - PERM_MIN
    (the kernel's gradient table, read by a corner's last permute
    argument)."""
    x = torch.arange(PERM_MIN, PERM_MAX + 1, dtype=torch.float32)
    return _scaled_grads(_permute(x))


def cnoise_table(px, py, pz, grad, perm):
    """cnoise_v3 as the kernel computes it: where every |floor(p)| is below
    TABLE_LIMIT, the permutes from ``perm`` and the gradients from
    ``grad`` (permute_table, gradient_table); elsewhere both computed."""
    fpx, fpy, fpz = torch.floor(px), torch.floor(py), torch.floor(pz)
    x0i, y0i, z0i = _mod289(fpx), _mod289(fpy), _mod289(fpz)
    x1i, y1i, z1i = (_mod289(fpx + 1.0), _mod289(fpy + 1.0),
                     _mod289(fpz + 1.0))
    x0, y0, z0 = px - fpx, py - fpy, pz - fpz
    x1, y1, z1 = x0 - 1.0, y0 - 1.0, z0 - 1.0
    inside = ((fpx.abs() < TABLE_LIMIT) & (fpy.abs() < TABLE_LIMIT)
              & (fpz.abs() < TABLE_LIMIT))

    def idx(v):  # a lattice value as a table argument (0 outside)
        return torch.where(inside, v, 0.0).to(torch.int64) - PERM_MIN

    fz = _fade(z0)
    nz = []
    for c in range(4):   # (x0,y0) (x1,y0) (x0,y1) (x1,y1), as cnoise_v3's
        cx, cy = (x1i if c & 1 else x0i), (y1i if c & 2 else y0i)
        xx, yy = (x1 if c & 1 else x0), (y1 if c & 2 else y0)
        ixy_t = perm[perm[idx(cx)] + idx(cy)]
        ixy_a = _permute(_permute(cx) + cy)
        n = []
        for czi, cz in ((z0i, z0), (z1i, z1)):
            g = torch.where(inside[..., None], grad[ixy_t + idx(czi)],
                            _scaled_grads(_permute(ixy_a + czi)))
            n.append(g[..., 0] * xx + g[..., 1] * yy + g[..., 2] * cz)
        nz.append(_mix(n[0], n[1], fz))
    fy, fx = _fade(y0), _fade(x0)
    return 2.2 * _mix(_mix(nz[0], nz[2], fy), _mix(nz[1], nz[3], fy), fx)


def turbulence_table(px, py, pz, grad, perm, depth: int = OCTAVES):
    """turbulence_v3 over cnoise_table: one lane's turbulence."""
    accum = torch.zeros_like(px)
    weight = 1.0
    for _ in range(depth):
        accum = accum + weight * cnoise_table(px, py, pz, grad, perm)
        weight *= 0.5
        px, py, pz = px * 2.0, py * 2.0, pz * 2.0
    return torch.abs(accum)

