"""The benchmark's plain reference: a brute-force path tracer in PyTorch.

It follows tests/oracle_tracer.py (a numpy/f64 tracer written from the
reference renderer's GLSL, ray_gen.glsl) operation for operation, with
its documented quirks: the gradient sky ignores the ray's direction,
emission counts on front faces only, t in (1e-3, 1e4), the thin-lens
offset is added to the world-space origin scaled by the NDC coordinate,
lambertian surfaces in a scene with lights scatter by the 50/50 mixture
of the light sample and the cosine lobe (ray_gen.glsl:252-341), and the
light sample takes the OBJECT-space light triangle through the HIT
primitive's object-to-world transform.  It is re-expressed in torch so
that it can run on the card at the benchmark's sizes, and it traces only
the pixels it is given:

- every sphere and triangle is tested against every ray (no tree);
- a pixel's samples are stratified as the program's are: sample j takes
  sub-pixel cell j mod (sqrt_spp^2), so its mean and the program's have
  the same distribution;
- it returns, per pixel, the mean radiance and the mean over the cells of
  the variance within a cell, from which the comparison derives how far
  a correct image may lie from it.

Static scenes of analytic spheres, triangles, quads and boxes, with
constant and checker textures and lambertian, metal, dielectric and
diffuse-light materials: what the benchmark's configurations use.  It
reads the scene document the benchmark made and imports nothing of the
program.  ``dtype`` is the precision of every operation on a path
(float64 for the reference; a lower one makes the control); the means
and variances are taken in float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

T_MIN, T_MAX = 1e-3, 1e4
LAMBERTIAN, METAL, DIELECTRIC, LIGHT = 0, 1, 2, 3
# Elements of the largest [rays, primitives] temporary of the hit test.
_HIT_CHUNK = 1 << 24


# ------------------------------------------------------------ scene

def _quad_tris(points, normal):
    p = [np.asarray(q, np.float64) for q in points]
    n = np.asarray(normal, np.float64)
    return [(p[0], p[1], p[2], n), (p[0], p[2], p[3], n)]


def _box_tris(c0, c1):
    lo = np.minimum(np.asarray(c0, np.float64), np.asarray(c1, np.float64))
    hi = np.maximum(np.asarray(c0, np.float64), np.asarray(c1, np.float64))
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    quads = [
        ([(x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1)], (0, 0, 1)),
        ([(x1, y0, z0), (x0, y0, z0), (x0, y1, z0), (x1, y1, z0)], (0, 0, -1)),
        ([(x1, y0, z1), (x1, y0, z0), (x1, y1, z0), (x1, y1, z1)], (1, 0, 0)),
        ([(x0, y0, z0), (x0, y0, z1), (x0, y1, z1), (x0, y1, z0)], (-1, 0, 0)),
        ([(x0, y1, z1), (x1, y1, z1), (x1, y1, z0), (x0, y1, z0)], (0, 1, 0)),
        ([(x0, y0, z0), (x1, y0, z0), (x1, y0, z1), (x0, y0, z1)], (0, -1, 0)),
    ]
    tris = []
    for q, n in quads:
        tris += _quad_tris(q, n)
    return tris


def _quat_matrix(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _static_matrix(tf) -> np.ndarray:
    """An instance's object-to-world T.R.S matrix [4, 4] (instance.rs:43-54);
    animated transforms are refused."""
    if tf and "static" not in tf:
        raise ValueError(f"reference: only static transforms, not {tf}")
    t = (tf or {}).get("static") or {}
    tr = np.asarray(t.get("translate") or [0.0, 0.0, 0.0], np.float64)
    sc = np.asarray(t.get("scale") or [1.0, 1.0, 1.0], np.float64)
    q = np.array([1.0, 0.0, 0.0, 0.0])
    if t.get("rotate"):
        ax = np.asarray(t["rotate"]["axis"], np.float64)
        ax = ax / np.linalg.norm(ax)
        half = 0.5 * np.deg2rad(t["rotate"]["degrees"])
        q = np.array([np.cos(half), *(np.sin(half) * ax)])
    m = np.eye(4)
    m[:3, :3] = _quat_matrix(q) @ np.diag(sc)
    m[:3, 3] = tr
    return m


def _look_at_rh(eye, center, up):
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4)
    m[0, :3], m[1, :3], m[2, :3] = s, u, -f
    m[0, 3], m[1, 3], m[2, 3] = -s @ eye, -u @ eye, f @ eye
    return m


def _perspective_rh(fovy, aspect, znear, zfar):
    h = 1.0 / np.tan(0.5 * fovy)
    m = np.zeros((4, 4))
    m[0, 0], m[1, 1] = h / aspect, h
    m[2, 2] = zfar / (znear - zfar)
    m[2, 3] = -(zfar * znear) / (zfar - znear)
    m[3, 2] = -1.0
    return m


class Scene:
    """A scene document's world-space tables on ``device`` in ``dtype``:
    spheres first, then triangles (the program's primitive order)."""

    def __init__(self, doc: dict, width: int, height: int, device,
                 dtype=torch.float64):
        self.device, self.dtype = torch.device(device), dtype
        self.width, self.height = width, height
        tex_names, tex_rows = {}, []
        for t in doc["textures"]:
            kind = next(iter(t))
            tex_names[t[kind]["name"]] = len(tex_rows)
            tex_rows.append((kind, t[kind]))
        # Texture table: kind (0 constant, 1 checker), rgb, and for a
        # checker its scale and the rows of its two constant textures.
        nt = len(tex_rows)
        kind = np.zeros(nt, np.int64)
        rgb = np.zeros((nt, 3))
        scale = np.ones(nt)
        even = np.zeros(nt, np.int64)
        odd = np.zeros(nt, np.int64)
        for i, (k, body) in enumerate(tex_rows):
            if k == "constant":
                rgb[i] = body["rgb"]
            elif k == "checker":
                kind[i], scale[i] = 1, float(body["scale"])
                even[i] = tex_names[body["even"]]
                odd[i] = tex_names[body["odd"]]
                if tex_rows[even[i]][0] != "constant" or (
                        tex_rows[odd[i]][0] != "constant"):
                    raise ValueError("reference: a checker of constants only")
            else:
                raise ValueError(f"reference: unsupported texture {k}")

        mat_names, mat_rows = {}, []
        for m in doc["materials"]:
            k = next(iter(m))
            body = m[k]
            mat_names[body["name"]] = len(mat_rows)
            if k == "lambertian":
                mat_rows.append((LAMBERTIAN, tex_names[body["albedo"]], 0,
                                 1.0))
            elif k == "metal":
                mat_rows.append((METAL, tex_names[body["albedo"]],
                                 tex_names[body["fuzz"]], 1.0))
            elif k == "dielectric":
                mat_rows.append((DIELECTRIC, 0, 0,
                                 float(body["refraction_index"])))
            elif k == "diffuse_light":
                mat_rows.append((LIGHT, tex_names[body["emit"]], 0, 1.0))
            else:
                raise ValueError(f"reference: unsupported material {k}")

        prims = {p[next(iter(p))]["name"]: (next(iter(p)), p[next(iter(p))])
                 for p in doc["primitives"]}
        sph_c, sph_r, sph_m, sph_x = [], [], [], []
        tri, tri_m, tri_x = [], [], []
        lights, light_area = [], []
        for inst in doc["instances"]:
            xf = _static_matrix(inst.get("transform"))
            k, body = prims[inst["name"]]
            mat = mat_names[body["material"]]
            if k == "uv_sphere":
                s = np.linalg.norm(xf[:3, :3], axis=0)
                if not np.allclose(s, s[0]):
                    raise ValueError("reference: non-uniform sphere scale")
                sph_c.append(xf[:3, :3] @ np.asarray(body["center"])
                             + xf[:3, 3])
                sph_r.append(float(body["radius"]) * s[0])
                sph_m.append(mat)
                sph_x.append(xf)
                if mat_rows[mat][0] == LIGHT:
                    raise ValueError("reference: sphere lights unsupported")
                continue
            if k == "quad":
                local = _quad_tris(body["points"], body["normal"])
            elif k == "box":
                local = _box_tris(*body["corners"])
            elif k == "triangle":
                local = [tuple(np.asarray(q, np.float64)
                               for q in body["points"])
                         + (np.asarray(body["normal"], np.float64),)]
            else:
                raise ValueError(f"reference: unsupported primitive {k}")
            for p0, p1, p2, n in local:
                w = [xf[:3, :3] @ p + xf[:3, 3] for p in (p0, p1, p2)]
                nw = xf[:3, :3] @ n
                tri.append(np.concatenate([w[0], w[1] - w[0], w[2] - w[0],
                                           nw / np.linalg.norm(nw)]))
                tri_m.append(mat)
                tri_x.append(xf)
                if mat_rows[mat][0] == LIGHT:
                    # Lights: object-space triangles, world areas, the
                    # degenerate-area cutoff (light.rs:63-88).
                    a = 0.5 * np.linalg.norm(np.cross(w[1] - w[0],
                                                      w[2] - w[0]))
                    if a > 1e-8:
                        lights.append(np.concatenate([p0, p1, p2]))
                        light_area.append(a)

        def T(a, dt=None):
            return torch.tensor(np.asarray(a), dtype=dt or dtype,
                                device=self.device)

        self.tex_kind, self.tex_rgb, self.tex_scale = (
            T(kind, torch.int64), T(rgb), T(scale))
        self.tex_even, self.tex_odd = T(even, torch.int64), T(odd, torch.int64)
        mr = np.asarray(mat_rows, np.float64).reshape(-1, 4)
        self.mat_kind = T(mr[:, 0], torch.int64)
        self.mat_tex = T(mr[:, 1], torch.int64)
        self.mat_fuzz = T(mr[:, 2], torch.int64)
        self.mat_ri = T(mr[:, 3])
        self.n_sph = len(sph_c)
        self.sph_c = T(np.reshape(sph_c, (-1, 3)))
        self.sph_r = T(np.reshape(sph_r, (-1,)))
        # |c|^2 - r^2 in float64 before the cast: the ground sphere's
        # 1e6 - 1e6.
        self.sph_k = T(np.sum(np.reshape(sph_c, (-1, 3)) ** 2, -1)
                       - np.reshape(sph_r, (-1,)) ** 2)
        tri = np.reshape(tri, (-1, 12))
        self.tri_v0, self.tri_e1, self.tri_e2, self.tri_n = (
            T(tri[:, 0:3]), T(tri[:, 3:6]), T(tri[:, 6:9]), T(tri[:, 9:12]))
        self.prim_mat = T(sph_m + tri_m, torch.int64)
        self.prim_xf = T(np.reshape(sph_x + tri_x, (-1, 4, 4))[:, :3, :])
        lights = np.reshape(lights, (-1, 9))
        self.light_v = T(lights.reshape(-1, 3, 3))
        area = np.asarray(light_area, np.float64)
        self.light_total_area = float(area.sum())
        self.light_cdf = torch.tensor(
            np.cumsum(area) / max(area.sum(), 1e-300), dtype=torch.float64,
            device=self.device)

        sky = doc["sky"]
        if "solid" in sky:
            sky_rgb = np.asarray(sky["solid"]["rgb"], np.float64)
        else:
            g = sky["vertical_gradient"]
            f = float(g["factor"])
            sky_rgb = ((1.0 - f) * np.asarray(g["top"], np.float64)
                       + f * np.asarray(g["bottom"], np.float64))
        self.sky = T(sky_rgb)

        render = doc["render"]
        cam = next(c[next(iter(c))] for c in doc["cameras"]
                   if c[next(iter(c))]["name"] == render["camera"])
        eye = np.asarray(cam["eye"], np.float64)
        view = _look_at_rh(eye, np.asarray(cam["look_at"], np.float64),
                           np.asarray(cam["up"], np.float64))
        proj = _perspective_rh(np.deg2rad(cam["fov_y"]), width / height,
                               cam["z_near"], cam["z_far"])
        self.eye = T(eye)
        self.view_inv = T(np.linalg.inv(view))
        self.proj_inv = T(np.linalg.inv(proj))
        self.aperture = float(cam.get("aperture_size") or 0.0)
        self.focal = float(cam.get("focal_length") or 1.0)

    # -------------------------------------------------------- textures

    def texture(self, tex: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """ray_gen.glsl:184-243: a constant, or a checker of two constants
        by the parity of floor(p / scale) summed over the axes."""
        rgb = self.tex_rgb[tex]
        checker = self.tex_kind[tex] == 1
        if not bool(checker.any()):
            return rgb
        cells = torch.floor(p / self.tex_scale[tex][:, None]).to(torch.int64)
        even = cells.sum(-1) % 2 == 0
        pick = torch.where(even, self.tex_even[tex], self.tex_odd[tex])
        return torch.where(checker[:, None], self.tex_rgb[pick], rgb)


# ---------------------------------------------------------- sampling

def _dot(a, b):
    return (a * b).sum(-1)


def _normalize(v):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


class _Draws:
    """Uniform draws in [0, 1) from one seeded generator, cast to the
    path's precision."""

    def __init__(self, seed: int, device, dtype):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed & ((1 << 63) - 1))
        self.device, self.dtype = device, dtype
        self.wide = torch.float64 if dtype == torch.float64 else torch.float32

    def __call__(self, *shape):
        return torch.rand(*shape, generator=self.gen, device=self.device,
                          dtype=self.wide).to(self.dtype)

    def normal(self, *shape):
        return torch.randn(*shape, generator=self.gen, device=self.device,
                           dtype=self.wide).to(self.dtype)


def _disk_concentric(n, rnd):
    """sampleUniformDiskConcentric (common.glsl:353-373)."""
    u = 2.0 * rnd(n, 2) - 1.0
    ax, ay = u[:, 0].abs(), u[:, 1].abs()
    x_major = ax > ay
    r = torch.where(x_major, u[:, 0], u[:, 1])

    def safe(a, b):
        return a / torch.where(b == 0.0, torch.ones_like(b), b)

    theta = torch.where(x_major, (math.pi / 4) * safe(u[:, 1], u[:, 0]),
                        (math.pi / 2) - (math.pi / 4) * safe(u[:, 0], u[:, 1]))
    pt = r[:, None] * torch.stack([torch.cos(theta), torch.sin(theta)], -1)
    return torch.where((u == 0.0).all(-1, keepdim=True),
                       torch.zeros_like(pt), pt)


def _camera_rays(sc: Scene, px, py, si, sj, sqrt_spp, rnd):
    """Primary rays through sub-pixel cell (si, sj) of pixels (px, py),
    with the thin-lens quirk (ray_gen.glsl:543-571)."""
    n = px.shape[0]
    u = (px + (si + rnd(n)) / sqrt_spp) / sc.width * 2.0 - 1.0
    v = (py + (sj + rnd(n)) / sqrt_spp) / sc.height * 2.0 - 1.0
    one = torch.ones_like(u)
    ndc = torch.stack([u, v, one, one], -1)
    t3 = _normalize((ndc @ sc.proj_inv.T)[:, :3])
    d = t3 @ sc.view_inv[:3, :3].T
    o = sc.eye.expand(n, 3).clone()
    if sc.aperture > 0.0:
        fp = sc.focal * t3 @ sc.view_inv[:3, :3].T + sc.view_inv[:3, 3]
        lens = _disk_concentric(n, rnd) * (sc.aperture / 2.0)
        o[:, 0] += lens[:, 0] * u
        o[:, 1] += lens[:, 1] * v
        d = fp - o
    return o, _normalize(d)


def _closest_hit(sc: Scene, o, d):
    """(t, primitive) of the nearest hit in (T_MIN, T_MAX), spheres then
    triangles, the lowest id winning a tie; t = T_MAX on a miss."""
    n = o.shape[0]
    best_t = torch.full((n,), T_MAX, dtype=o.dtype, device=o.device)
    best_id = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    big = torch.tensor(T_MAX, dtype=o.dtype, device=o.device)
    ns, nt = sc.n_sph, sc.tri_v0.shape[0]
    for count, test, base in ((ns, _sphere_t, 0), (nt, _tri_t, ns)):
        if count == 0:
            continue
        step = max(1, _HIT_CHUNK // (count * (3 if test is _tri_t else 1)))
        for a in range(0, n, step):
            t = test(sc, o[a:a + step], d[a:a + step], big)
            tmin, arg = t.min(-1)
            better = tmin < best_t[a:a + step]
            best_t[a:a + step] = torch.where(better, tmin, best_t[a:a + step])
            best_id[a:a + step] = torch.where(better, arg + base,
                                              best_id[a:a + step])
    return best_t, best_id


def _sphere_t(sc, o, d, big):
    a = _dot(d, d)[:, None]
    h = _dot(d, o)[:, None] - d @ sc.sph_c.T
    c = _dot(o, o)[:, None] - 2.0 * (o @ sc.sph_c.T) + sc.sph_k[None]
    disc = h * h - a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t1, t2 = (-h - sq) / a, (-h + sq) / a
    ok = disc >= 0.0
    return torch.where(ok & (t1 > T_MIN) & (t1 < T_MAX), t1,
                       torch.where(ok & (t2 > T_MIN) & (t2 < T_MAX), t2, big))


def _tri_t(sc, o, d, big):
    e1, e2 = sc.tri_e1[None], sc.tri_e2[None]
    p = _cross(d[:, None, :].expand(-1, e2.shape[1], -1),
               e2.expand(d.shape[0], -1, -1))
    det = _dot(p, e1)
    nz = det != 0.0
    inv = torch.where(nz, 1.0 / torch.where(nz, det, torch.ones_like(det)),
                      torch.zeros_like(det))
    tv = o[:, None, :] - sc.tri_v0[None]
    uu = _dot(tv, p) * inv
    q = _cross(tv, e1.expand_as(tv))
    vv = _dot(d[:, None, :], q) * inv
    t = _dot(q, e2) * inv
    ok = (nz & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0) & (t > T_MIN)
          & (t < T_MAX))
    return torch.where(ok, t, big)


def _cosine_dir(normal, rnd):
    n = normal.shape[0]
    r1, r2 = rnd(n), rnd(n)
    phi = 2 * math.pi * r1
    x = torch.cos(phi) * torch.sqrt(r2)
    y = torch.sin(phi) * torch.sqrt(r2)
    z = torch.sqrt(1 - r2)
    ey, ex = (torch.tensor(v, dtype=normal.dtype, device=normal.device)
              for v in ([0.0, 1.0, 0.0], [1.0, 0.0, 0.0]))
    a = torch.where(normal[:, 0:1].abs() > 0.9, ey, ex)
    v = _normalize(_cross(normal, a))
    u = _cross(normal, v)
    return x[:, None] * u + y[:, None] * v + z[:, None] * normal


def _scatter(sc: Scene, o, d, thr, t, prim, acc, rnd):
    """One bounce of rays that hit: adds emission to ``acc``; returns
    (scattered, new origin, new direction, new throughput)."""
    n = o.shape[0]
    hp = o + t[:, None] * d
    is_sph = prim < sc.n_sph
    sid = torch.clamp(prim, max=max(sc.n_sph - 1, 0))
    tid = torch.clamp(prim - sc.n_sph, min=0)
    if sc.n_sph and sc.tri_v0.shape[0]:
        gn = torch.where(is_sph[:, None],
                         (hp - sc.sph_c[sid]) / sc.sph_r[sid][:, None],
                         sc.tri_n[tid])
    elif sc.n_sph:
        gn = (hp - sc.sph_c[sid]) / sc.sph_r[sid][:, None]
    else:
        gn = sc.tri_n[tid]
    front = _dot(d, gn) < 0.0
    nrm = torch.where(front[:, None], gn, -gn)
    mat = sc.prim_mat[prim]
    kind = sc.mat_kind[mat]
    tex = sc.mat_tex[mat]

    light = (kind == LIGHT) & front
    emit = sc.texture(tex, hp)
    acc += torch.where(light[:, None], thr * emit, torch.zeros_like(acc))

    new_d = d.clone()
    new_thr = thr.clone()
    scattered = torch.zeros(n, dtype=torch.bool, device=o.device)

    lam = kind == LAMBERTIAN
    if bool(lam.any()):
        alb = emit  # the albedo texture, evaluated above
        if sc.light_total_area > 0.0:
            li = torch.searchsorted(sc.light_cdf, torch.rand(
                n, generator=rnd.gen, device=o.device,
                dtype=torch.float64).contiguous())
            li = torch.clamp(li, max=sc.light_v.shape[0] - 1)
            r1, r2 = rnd(n), rnd(n)
            sq = torch.sqrt(r1)
            b0, b1 = 1 - sq, sq * r2
            xf = sc.prim_xf[prim]
            w = torch.einsum("nij,nkj->nki", xf[:, :, :3], sc.light_v[li]) \
                + xf[:, None, :, 3]
            e1, e2 = w[:, 1] - w[:, 0], w[:, 2] - w[:, 0]
            lpos = w[:, 0] + b0[:, None] * e1 + b1[:, None] * e2
            lnrm = _normalize(_cross(e1, e2))
            use_light = rnd(n) < 0.5
            cos_d = _cosine_dir(nrm, rnd)
            ldir = lpos - hp
            sdir = torch.where(use_light[:, None], ldir, cos_d)
            sn = sdir / torch.clamp(torch.linalg.vector_norm(
                sdir, dim=-1, keepdim=True), min=1e-30)
            pdf_cos = torch.clamp(_dot(sn, nrm) / math.pi, min=0.0)
            d2 = _dot(sdir, sdir)
            cos_l = _dot(lnrm, -sn).abs()
            pdf_light = torch.where(
                cos_l > 0.0,
                d2 / torch.clamp(cos_l, min=1e-30) / sc.light_total_area,
                torch.zeros_like(d2))
            pdf_val = 0.5 * pdf_light + 0.5 * pdf_cos
            ratio = torch.where(
                pdf_val > 0.0,
                pdf_cos / torch.where(pdf_val == 0.0,
                                      torch.ones_like(pdf_val), pdf_val),
                torch.zeros_like(pdf_val))
            new_thr = torch.where(lam[:, None], thr * alb * ratio[:, None],
                                  new_thr)
            new_d = torch.where(lam[:, None], sn, new_d)
        else:
            new_d = torch.where(lam[:, None], _cosine_dir(nrm, rnd), new_d)
            new_thr = torch.where(lam[:, None], thr * alb, new_thr)
        scattered |= lam

    met = kind == METAL
    if bool(met.any()):
        fuzz = sc.texture(sc.mat_fuzz[mat], hp)
        refl = d - 2 * _dot(d, nrm)[:, None] * nrm
        unit = _normalize(rnd.normal(n, 3))
        fd = _normalize(refl) + fuzz * unit
        new_d = torch.where(met[:, None], fd, new_d)
        new_thr = torch.where(met[:, None], thr * emit, new_thr)
        scattered |= met & (_dot(refl, nrm) > 0)

    die = kind == DIELECTRIC
    if bool(die.any()):
        ri_tab = sc.mat_ri[mat]
        ri = torch.where(front, 1.0 / ri_tab, ri_tab)
        ud = _normalize(d)
        ct = torch.clamp(_dot(-ud, nrm), max=1.0)
        st = torch.sqrt(torch.clamp(1 - ct * ct, min=0.0))
        r0 = ((1 - ri) / (1 + ri)) ** 2
        schlick = r0 + (1 - r0) * (1 - ct) ** 5
        cannot = (ri * st > 1.0) | (schlick > rnd(n))
        refl = ud - 2 * _dot(ud, nrm)[:, None] * nrm
        perp = ri[:, None] * (ud + ct[:, None] * nrm)
        par = -torch.sqrt((1.0 - _dot(perp, perp)).abs())[:, None] * nrm
        nd = torch.where(cannot[:, None], refl, perp + par)
        new_d = torch.where(die[:, None], nd, new_d)
        scattered |= die

    nn = torch.clamp(torch.linalg.vector_norm(new_d, dim=-1, keepdim=True),
                     min=1e-30)
    return scattered, hp, new_d / nn, new_thr


def _trace(sc: Scene, o, d, max_depth: int, rnd):
    """Radiance [n, 3] of paths starting with rays (o, d)."""
    n = o.shape[0]
    acc = torch.zeros((n, 3), dtype=o.dtype, device=o.device)
    thr = torch.ones_like(acc)
    idx = torch.arange(n, device=o.device)
    for _ in range(max_depth):
        t, prim = _closest_hit(sc, o, d)
        missed = t >= T_MAX
        acc.index_add_(0, idx[missed], thr[missed] * sc.sky)
        hit = ~missed
        idx, o, d, thr, t, prim = (a[hit] for a in (idx, o, d, thr, t, prim))
        if idx.numel() == 0:
            break
        part = torch.zeros((idx.numel(), 3), dtype=o.dtype, device=o.device)
        cont, o, d, thr = _scatter(sc, o, d, thr, t, prim, part, rnd)
        acc.index_add_(0, idx, part)
        idx, o, d, thr = idx[cont], o[cont], d[cont], thr[cont]
        if idx.numel() == 0:
            break
    return acc


def render_pixels(doc: dict, px, py, width: int, height: int, samples: int,
                  sqrt_spp: int, max_depth: int, *, seed: int, device="cpu",
                  dtype=torch.float64, block: int = 1 << 20):
    """Trace ``samples`` stratified samples of each pixel (px[i], py[i]).

    Sample j of a pixel takes sub-pixel cell j mod sqrt_spp^2, so
    ``samples`` must be a multiple of sqrt_spp^2.  Returns float64 numpy
    arrays (mean [P, 3], var [P, 3]): each pixel's mean radiance, and the
    mean over its cells of the unbiased variance of one sample within a
    cell (the variance of a mean of m stratified samples is var / m)."""
    cells = sqrt_spp * sqrt_spp
    if samples % cells or samples // cells < 2:
        raise ValueError(f"samples ({samples}) must be a multiple of "
                         f"{cells} cells, at least two a cell")
    dev = torch.device(device)
    sc = Scene(doc, width, height, dev, dtype)
    rnd = _Draws(seed, dev, dtype)
    px = torch.as_tensor(np.asarray(px), dtype=torch.int64, device=dev)
    py = torch.as_tensor(np.asarray(py), dtype=torch.int64, device=dev)
    n_pix = px.shape[0]
    total = n_pix * samples
    sums = torch.zeros((n_pix * cells, 3), dtype=torch.float64, device=dev)
    sq = torch.zeros_like(sums)
    for a in range(0, total, block):
        f = torch.arange(a, min(a + block, total), device=dev)
        pix, j = f // samples, f % samples
        cell = j % cells
        o, d = _camera_rays(sc, px[pix].to(dtype), py[pix].to(dtype),
                            (cell % sqrt_spp).to(dtype),
                            (cell // sqrt_spp).to(dtype), sqrt_spp, rnd)
        rad = _trace(sc, o, d, max_depth, rnd).to(torch.float64)
        slot = pix * cells + cell
        sums.index_add_(0, slot, rad)
        sq.index_add_(0, slot, rad * rad)
    m = samples // cells
    sums = sums.view(n_pix, cells, 3)
    sq = sq.view(n_pix, cells, 3)
    var = ((sq - sums * sums / m) / (m - 1)).clamp(min=0.0).mean(1)
    mean = sums.sum(1) / samples
    return mean.cpu().numpy(), var.cpu().numpy()
