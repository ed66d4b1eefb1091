"""Next-event estimation with lights: the port's ops/nee.py, rng.py and
vec3.py functions against raytrace_tpu.ops.nee / .rng / .vec3 on the same
numpy-seeded states, triangles and transforms, with a real alias table
from models/alias_table.py; and the two light scenes' compiled light
tables, port against JAX, field by field.

Tolerances: RNG words, mixture choices and chosen light indices match bit
for bit; positions and normals within atol=1e-5 relative to each
coordinate's magnitude (rtol=1e-5): XLA's CPU build contracts
multiply-adds into FMAs and torch does not, so the last bits of M p + t
and of the triangle lerp may differ.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.engine import arrays as jarrays
from raytrace_tpu.models import compile_scene as jax_compile_scene
from raytrace_tpu.ops import nee as jnee
from raytrace_tpu.ops import rng as jrng
from raytrace_tpu.ops import vec3 as jvec3
from raytrace_tpu.scene_file import SceneFile as JaxSceneFile
from raytrace_tpu_torch.engine import arrays as tarrays
from raytrace_tpu_torch.models import compile_scene
from raytrace_tpu_torch.models.alias_table import build_alias_table
from raytrace_tpu_torch.ops import nee as tnee
from raytrace_tpu_torch.ops import rng as trng
from raytrace_tpu_torch.ops import vec3 as tvec3
from raytrace_tpu_torch.ops.materials import COSINE_PDF, LIGHT_PDF, NO_PDF
from raytrace_tpu_torch.ops.vec3 import V3
from raytrace_tpu_torch.scene_file import SceneFile
from raytrace_tpu_torch.tools import light_scenes

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
N = 4096


def _states(n=N, seed=0):
    s = np.random.default_rng(seed).integers(0, 2 ** 32, n, dtype=np.uint64)
    s[:2] = [0, 2 ** 32 - 1]
    return jnp.asarray(s.astype(np.uint32)), torch.tensor(s.astype(np.int64))


def _same_words(j, t):
    np.testing.assert_array_equal(np.asarray(j).astype(np.int64), t.numpy())


def _jv(a):
    return jvec3.V3(*(jnp.asarray(np.ascontiguousarray(a[:, i]))
                      for i in range(3)))


def _tv(a):
    return V3(*(torch.tensor(np.ascontiguousarray(a[:, i])) for i in range(3)))


def _close(j, t):
    for a, b in zip(j, t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


def _o2w(n, seed):
    """n random rotation-scale-translation 3x4 matrices, row-major [n, 12]."""
    g = np.random.default_rng(seed)
    q, _ = np.linalg.qr(g.standard_normal((n, 3, 3)))
    m = q * g.uniform(0.5, 2.0, (n, 1, 3))
    t = g.uniform(-300, 300, (n, 3, 1))
    return np.concatenate([m, t], axis=2).reshape(n, 12).astype(np.float32)


def _cols(rows):
    return (tuple(jnp.asarray(rows[:, i].copy()) for i in range(12)),
            tuple(torch.tensor(rows[:, i].copy()) for i in range(12)))


def _light_scenes(tri_p, areas):
    """The light fields of a JAX and a port scene for the same triangles
    and the alias table over ``areas``."""
    prob, alias, total = build_alias_table(areas)
    L = len(prob)
    packed = tarrays.light_table16(tri_p, prob, alias)
    jscene = types.SimpleNamespace(
        light_count=jnp.int32(L), light_prob=jnp.asarray(prob),
        light_alias=jnp.asarray(alias),
        light_tri_packed=jnp.asarray(np.pad(tri_p.reshape(L, 9),
                                            ((0, 0), (0, 7)))))
    tscene = types.SimpleNamespace(
        light_count=torch.tensor(L, dtype=torch.int32),
        light_prob=torch.tensor(prob), light_alias=torch.tensor(alias),
        light_tri_packed=torch.tensor(packed))
    return jscene, tscene, total


def test_mat34_apply_point_matches_jax():
    g = np.random.default_rng(3)
    rows = _o2w(N, seed=3)
    p = g.uniform(-600, 600, (N, 3)).astype(np.float32)
    jc, tc = _cols(rows)
    _close(jvec3.mat34_apply_point(jc, _jv(p)),
           tvec3.mat34_apply_point(tc, _tv(p)))


def test_sample_triangle_uniform_matches_jax():
    g = np.random.default_rng(4)
    tri = g.uniform(-50, 50, (3, N, 3)).astype(np.float32)
    js, ts = _states(seed=4)
    js, jp = jrng.sample_triangle_uniform_v3(js, *(_jv(t) for t in tri))
    ts, tp = trng.sample_triangle_uniform_v3(ts, *(_tv(t) for t in tri))
    _same_words(js, ts)
    _close(jp, tp)


def test_choose_mixture_pdf_with_lights_matches_jax():
    g = np.random.default_rng(5)
    mat = g.choice([NO_PDF, COSINE_PDF], N).astype(np.int32)
    js, ts = _states(seed=5)
    js, jc = jnee.choose_mixture_pdf(js, jnp.asarray(mat), True)
    ts, tc = tnee.choose_mixture_pdf(ts, torch.tensor(mat), True)
    _same_words(js, ts)
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    assert tc.dtype == torch.int32
    light = tc.numpy() == LIGHT_PDF
    assert 0.45 < light.mean() < 0.55
    np.testing.assert_array_equal(tc.numpy()[~light], mat[~light])


def test_alias_pick_chooses_the_same_light_as_jax():
    """Light k's triangle is the point (k, -k, 2k) three times over, and
    the transform is the identity, so a sampled position names the light
    the alias table chose, exactly."""
    L = 37
    k = np.arange(L, dtype=np.float32)
    pt = np.stack([k, -k, 2 * k], axis=1)
    tri_p = np.repeat(pt[:, None, :], 3, axis=1)
    areas = np.random.default_rng(6).uniform(0.1, 5.0, L).astype(np.float32)
    jscene, tscene, _ = _light_scenes(tri_p, areas)
    eye = np.zeros((N, 12), np.float32)
    eye[:, [0, 5, 10]] = 1.0
    jc, tc = _cols(eye)
    js, ts = _states(seed=6)
    js, jl = jnee.sample_light_sources_v3(js, jscene, jc)
    ts, tl = tnee.sample_light_sources_v3(ts, tscene, tc)
    _same_words(js, ts)
    j_idx = np.asarray(jl.position.x)
    t_idx = tl.position.x.numpy()
    np.testing.assert_array_equal(j_idx, t_idx)
    np.testing.assert_array_equal(tl.position.y.numpy(), -t_idx)
    # Every light is picked, in proportion to its area.
    counts = np.bincount(t_idx.astype(np.int64), minlength=L)
    assert (counts > 0).all()
    np.testing.assert_allclose(counts / N, areas / areas.sum(), atol=0.02)


@pytest.mark.parametrize("L", [2, 962])
def test_sample_light_sources_matches_jax(L):
    """Real triangles, a real alias table and a different transform per
    ray: positions and normals within the tolerance."""
    g = np.random.default_rng(L)
    c = g.uniform(-200, 200, (L, 1, 3))
    tri_p = (c + g.uniform(-20, 20, (L, 3, 3))).astype(np.float32)
    e1, e2 = tri_p[:, 1] - tri_p[:, 0], tri_p[:, 2] - tri_p[:, 0]
    areas = (0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)).astype(
        np.float32)
    jscene, tscene, _ = _light_scenes(tri_p, areas)
    jc, tc = _cols(_o2w(N, seed=L + 1))
    js, ts = _states(seed=L)
    js, jl = jnee.sample_light_sources_v3(js, jscene, jc)
    ts, tl = tnee.sample_light_sources_v3(ts, tscene, tc)
    _same_words(js, ts)
    _close(jl.position, tl.position)
    _close(jl.normal, tl.normal)
    nrm = np.stack([c.numpy() for c in tl.normal], 1)
    np.testing.assert_allclose(np.linalg.norm(nrm, axis=1), 1.0, atol=1e-5)


def test_light_sample_takes_the_hit_instance_transform():
    """The quirk (SURVEY §8 #2): two hits with the same RNG state on two
    differently placed instances pick the same light row and the same
    point on it in object space, and land at two world points, each the
    hit instance's transform of that point, each equal to JAX's."""
    tri_p = np.array([[[213, 554, 227], [343, 554, 227], [343, 554, 332]],
                      [[213, 554, 227], [343, 554, 332], [213, 554, 332]]],
                     np.float32)
    jscene, tscene, _ = _light_scenes(tri_p, np.ones(2, np.float32))
    eye = np.zeros(12, np.float32)
    eye[[0, 5, 10]] = 1.0
    rot = _o2w(1, seed=9)[0]
    rows = np.stack([eye, rot, eye, rot] * 256)
    jc, tc = _cols(rows)
    state = np.full(len(rows), 12345, np.uint64)
    state[2:] = np.random.default_rng(9).integers(0, 2 ** 32, len(rows) - 2)
    state[1] = state[0]
    js, jl = jnee.sample_light_sources_v3(jnp.asarray(state.astype(np.uint32)),
                                          jscene, jc)
    ts, tl = tnee.sample_light_sources_v3(torch.tensor(state.astype(np.int64)),
                                          tscene, tc)
    _same_words(js, ts)
    _close(jl.position, tl.position)
    pos = np.stack([c.numpy() for c in tl.position], 1)
    assert not np.allclose(pos[0], pos[1])
    m = rot.reshape(3, 4).astype(np.float64)
    np.testing.assert_allclose(m[:, :3] @ pos[0] + m[:, 3], pos[1],
                               rtol=1e-4, atol=1e-2)
    # The untransformed point lies on the light quad.
    assert pos[0][1] == 554.0 and 213 <= pos[0][0] <= 343


# ---- the light scenes' compiled tables ------------------------------------

@pytest.fixture(scope="module", params=sorted(light_scenes.DOCS))
def compiled(request):
    doc = light_scenes.DOCS[request.param]()
    jcs = jax_compile_scene(JaxSceneFile.from_json_dict(doc), width=32)
    return request.param, jcs, compile_scene(SceneFile.from_json_dict(doc),
                                             width=32)


def test_light_tables_match_jax_field_by_field(compiled):
    name, jcs, cs = compiled
    for field in ("light_prob", "light_alias", "light_tri_p"):
        np.testing.assert_array_equal(getattr(cs, field), getattr(jcs, field))
    assert cs.light_count == jcs.light_count
    assert cs.light_total_area == jcs.light_total_area
    assert cs.num_instances == jcs.num_instances
    expected = {"cornell-style": (2, 8, 36, 0),
                "sphere-light-962": (962, 4, 2, 3)}[name]
    assert (cs.light_count, cs.num_instances, cs.num_triangles,
            cs.num_spheres) == expected


def test_uploaded_light_rows_hold_the_alias_table(compiled):
    _, jcs, cs = compiled
    jscene, jstatic = jarrays.upload_scene(jcs)
    scene, static = tarrays.upload_scene(cs, "cpu")
    assert static.has_lights and static.num_instances == jstatic.num_instances
    packed = scene.light_tri_packed.numpy()
    np.testing.assert_array_equal(packed[:, 0:9],
                                  np.asarray(jscene.light_tri_packed)[:, 0:9])
    np.testing.assert_array_equal(packed[:, 9], cs.light_prob)
    np.testing.assert_array_equal(packed[:, 10].astype(np.int32),
                                  cs.light_alias)
    assert (packed[:, 11:] == 0).all()
    carried = tarrays.from_jax_scene(jscene)
    assert torch.equal(carried.light_tri_packed, scene.light_tri_packed)
    assert int(scene.light_count) == cs.light_count == packed.shape[0]
    assert float(scene.light_total_area) == np.float32(cs.light_total_area)
