"""Image textures, module by module: the port against the JAX package.

- ``textures.sample_image_nearest`` against JAX's on the same atlas of two
  images of different sizes (so the second is padded), with random image
  indices and UVs that include negative values and values of 1 or more:
  bit for bit.
- ``engine.arrays.pack_atlas``: every packed word decodes to the bytes,
  and so to the sRGB table's values, of the uint8 atlas.
- ``tools.image_scenes.texel_ids``: each colour names its texel.
- The sphere UVs of the port's ``reconstruct_hit`` (its world-to-object
  branch) against JAX's on the primary hits of the earth and of its
  rotating twin at a time where the globe has turned: texel ids equal on
  at least TEXEL_AGREEMENT of hits (XLA's CPU build contracts
  multiply-adds and its arccos and arctan2 are not torch's, so a UV whose
  u * w sits within a last bit of an integer may land in the next texel;
  measured: 100% of hits), normals and points within ATOL = 1e-5.
- ``scatter_and_emit_v3`` with image slots (the albedo, both sides of a
  checker, the emission) against JAX's on the same rows, hit points, UVs
  and RNG states: RNG states and integer outputs exact, the image slots'
  colours bit for bit (the same table entries), other floats within ATOL.
- ``prepare_batch``'s rows of an image scene against JAX's (its
  world-to-object branch, columns 0:49) bit for bit, and the port's own
  columns (triangle normals 49:58 and UVs 58:64) against its attribute
  table.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.engine import arrays as jarrays
from raytrace_tpu.engine import wavefront as jwavefront
from raytrace_tpu.models import compile_scene as jax_compile_scene
from raytrace_tpu.models.compile import (MAT_TYPE_DIFFUSE_LIGHT,
                                         MAT_TYPE_LAMBERTIAN)
from raytrace_tpu.models.shading_table import MODE_CHECKER, MODE_IMAGE
from raytrace_tpu.ops import shading as jshading
from raytrace_tpu.ops import spheres as jspheres
from raytrace_tpu.ops import textures as jtextures
from raytrace_tpu.ops import vec3 as jvec3
from raytrace_tpu.scene_file import SceneFile as JaxSceneFile
from raytrace_tpu_torch.engine import arrays, wavefront
from raytrace_tpu_torch.ops import camera, shading, spheres, textures
from raytrace_tpu_torch.ops.textures import TexFlags
from raytrace_tpu_torch.ops.vec3 import V3
from raytrace_tpu_torch.tools import image_scenes

torch.set_num_threads(1)

ATOL = 1e-5
TEXEL_AGREEMENT = 0.999
N = 4096
MAP = (128, 64)      # the texel-id image, width x height
SECOND = (40, 20)    # a second, smaller image: padded in the atlas


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    d = tmp_path_factory.mktemp("maps")
    return (image_scenes.texel_id_png(str(d / "map.png"), *MAP),
            image_scenes.texel_id_png(str(d / "second.png"), *SECOND))


def _two_image_doc(pngs):
    """image_mix_doc with a second image, the mirror sphere's albedo
    turned into it."""
    doc = image_scenes.image_mix_doc(pngs[0])
    doc["textures"].append({"image": {"name": "second", "path": pngs[1]}})
    doc["materials"].append({"lambertian": {"name": "second",
                                            "albedo": "second"}})
    doc["primitives"][2]["uv_sphere"]["material"] = "second"
    return doc


@pytest.fixture(scope="module")
def two_images(pngs):
    """(JAX CompiledScene, its scene arrays, the port's SceneArrays) of the
    two-image doc."""
    jcs = jax_compile_scene(JaxSceneFile.from_json_dict(_two_image_doc(pngs)),
                            width=16)
    assert jcs.atlas.shape == (2, MAP[1], MAP[0], 3)
    jscene, _ = jarrays.upload_scene(jcs)
    scene, _ = arrays.upload_scene(arrays.from_jax_compiled(jcs), "cpu")
    return jcs, jscene, scene


def _uv(g, n):
    """UVs over [-2.5, 3.5), with exact integers, halves and near-ones."""
    u = g.uniform(-2.5, 3.5, n).astype(np.float32)
    u[:8] = [0.0, -0.0, 1.0, -1.0, 2.0, 0.5, np.float32(1) - 2 ** -24, -1e-9]
    return u


def test_sample_image_nearest_matches_jax_bit_for_bit(two_images):
    jcs, jscene, scene = two_images
    g = np.random.default_rng(0)
    idx = g.integers(0, 2, N).astype(np.int32)
    u, v = _uv(g, N), _uv(g, N)[::-1].copy()
    want = np.asarray(jtextures.sample_image_nearest(
        jscene.atlas, jscene.atlas_wh, jscene.srgb_lut, jnp.asarray(idx),
        jnp.asarray(u), jnp.asarray(v)))
    got = textures.sample_image_nearest(
        scene.atlas, scene.atlas_wh, scene.srgb_lut, torch.tensor(idx),
        torch.tensor(u), torch.tensor(v))
    np.testing.assert_array_equal(got.numpy(), want)
    # The second image never reads the first image's padding: its texels
    # are the ids of a SECOND-sized image.
    sel = idx == 1
    ids = image_scenes.texel_ids(*SECOND)
    lut = textures.srgb_u8_to_linear_lut()
    x = np.clip(np.floor(np.mod(u[sel], 1.0) * SECOND[0]), 0, SECOND[0] - 1)
    y = np.clip(np.floor(np.mod(v[sel], 1.0) * SECOND[1]), 0, SECOND[1] - 1)
    np.testing.assert_array_equal(
        got.numpy()[sel], lut[ids[y.astype(int), x.astype(int)]])


def test_pack_atlas_decodes_to_the_same_texels(two_images):
    scene = two_images[2]
    words = arrays.pack_atlas(scene.atlas)
    assert words.dtype == torch.int32 and words.shape == scene.atlas.shape[:3]
    assert words.is_contiguous() and int(words.min()) >= 0
    for c in range(3):
        byte = (words >> (8 * c)) & 0xFF
        assert torch.equal(byte, scene.atlas[..., c].to(torch.int32))
        assert torch.equal(scene.srgb_lut[byte.long()],
                           scene.srgb_lut[scene.atlas[..., c].long()])
    assert int((words >> 24).abs().max()) == 0


def test_texel_ids_name_their_texel():
    ids = image_scenes.texel_ids(*image_scenes.EARTH_SIZE).astype(np.int64)
    x = ids[..., 0] + 256 * (ids[..., 2] % 22)
    y = ids[..., 1] + 256 * (ids[..., 2] // 22)
    w, h = image_scenes.EARTH_SIZE
    np.testing.assert_array_equal(x, np.arange(w)[None, :].repeat(h, 0))
    np.testing.assert_array_equal(y, np.arange(h)[:, None].repeat(w, 1))
    # The sRGB table keeps the bytes apart, so a sampled colour names them.
    assert len(np.unique(textures.srgb_u8_to_linear_lut())) == 256


def _texel(u, v, w, h):
    x = np.clip(np.floor(np.mod(u, 1.0) * w), 0, w - 1).astype(np.int64)
    y = np.clip(np.floor(np.mod(v, 1.0) * h), 0, h - 1).astype(np.int64)
    return y * w + x


@pytest.mark.parametrize("name,t", [("earth", 0.5),
                                    ("earth-motion-blur", 0.7)])
def test_sphere_uvs_match_jax_world_to_object_branch(pngs, name, t):
    make = {"earth": image_scenes.earth_doc,
            "earth-motion-blur": image_scenes.earth_motion_blur_doc}[name]
    jcs = jax_compile_scene(JaxSceneFile.from_json_dict(make(pngs[0])),
                            width=48)
    cs = arrays.from_jax_compiled(jcs)
    scene, static = arrays.upload_scene(cs, "cpu")
    static = dataclasses.replace(static, sphere_world_mode=True)
    tab = spheres.world_sphere_tables(cs, np.array([t], np.float32))[0]
    geom = wavefront.prepare_batch(static, scene, torch.tensor(tab),
                                   batch_time=torch.tensor(np.float32(t)))
    cam = camera.build_camera_arrays(cs.cameras[cs.render.camera],
                                     static.width, static.height, "cpu")
    _, o, d = wavefront.primary_rays(static, cam, 0, 0, static.height, False,
                                     "cpu")
    alive = torch.ones(o.x.shape[0], dtype=torch.bool)
    raw = wavefront.make_trace_fn(static, scene, geom)(o, d, alive)
    hit = ~raw.missed
    rows = geom.prim_rows[torch.where(hit, raw.prim, 0)]
    rec = wavefront.reconstruct_hit(raw, o, d, rows, geom,
                                    scene.sph_center.shape[0], True)
    assert hit.float().mean() > 0.3

    jscene, jstatic = jarrays.upload_scene(jcs)
    jstatic = dataclasses.replace(jstatic, sphere_world_mode=True)
    jgeom = jwavefront.prepare_batch(jstatic, jscene, jnp.float32(t),
                                     sph_table=jspheres.world_sphere_tables(
                                         jcs, np.array([t], np.float32))[0])
    j = lambda x: jnp.asarray(x.numpy())  # noqa: E731
    jraw = jwavefront.RawHit(*(j(x) for x in raw))
    jv = lambda v: jvec3.V3(*(j(c) for c in v))  # noqa: E731
    jrec = jwavefront.reconstruct_hit(jstatic, jscene, jgeom, jraw, jv(o),
                                      jv(d), rows=j(rows))
    h = hit.numpy()
    for a, b in ((jrec.p, rec.p), (jrec.n, rec.n)):
        for ja, tb in zip(a, b):
            np.testing.assert_allclose(tb.numpy()[h], np.asarray(ja)[h],
                                       rtol=0, atol=ATOL)
    w, hh = MAP
    same = (_texel(rec.u.numpy(), rec.v.numpy(), w, hh)
            == _texel(np.asarray(jrec.u), np.asarray(jrec.v), w, hh))[h]
    assert same.mean() >= TEXEL_AGREEMENT, same.mean()
    # The UVs span the globe's visible face, not one texel.
    assert len(np.unique(_texel(rec.u.numpy()[h], rec.v.numpy()[h], w,
                                hh))) > 200


def _image_rows(case: str, g) -> np.ndarray:
    """[N, 32] fat rows whose slot of one kind is in image mode, with
    image indices -1..2 (clipped to the two images)."""
    rows = np.zeros((N, 32), np.float32)
    idx = g.integers(-1, 3, N).astype(np.float32)
    if case == "emission":
        rows[:, 0] = MAT_TYPE_DIFFUSE_LIGHT
        rows[:, 15], rows[:, 16] = MODE_IMAGE, idx
        return rows
    rows[:, 0] = MAT_TYPE_LAMBERTIAN
    if case == "albedo":
        rows[:, 11], rows[:, 12] = MODE_IMAGE, idx
        return rows
    rows[:, 11], rows[:, 17] = MODE_CHECKER, 0.5
    side = g.random(N) < 0.5   # the image on the even or on the odd side
    rows[:, 24] = np.where(side, MODE_IMAGE, 0.0)
    rows[:, 26] = np.where(side, 0.0, MODE_IMAGE)
    rows[:, 25] = rows[:, 27] = idx
    rows[:, 18:24] = g.random((N, 6))
    return rows


@pytest.mark.parametrize("case", ["albedo", "checker", "emission"])
def test_image_slots_match_jax(two_images, case):
    jcs, jscene, scene = two_images
    g = np.random.default_rng({"albedo": 0, "checker": 1, "emission": 2}[case])
    rows = _image_rows(case, g)
    p = g.uniform(-12, 12, (N, 3)).astype(np.float32)
    normal = g.standard_normal((N, 3))
    normal = (normal / np.linalg.norm(normal, axis=1,
                                      keepdims=True)).astype(np.float32)
    wrd = g.standard_normal((N, 3)).astype(np.float32)
    front = g.random(N) < 0.5
    u, v = _uv(g, N), _uv(g, N)[::-1].copy()
    state = g.integers(0, 2 ** 32, N, dtype=np.uint64)
    flags = (True, case == "checker", False, case == "emission")
    jv = lambda a: jvec3.V3(*(jnp.asarray(a[:, i]) for i in range(3)))  # noqa
    tv = lambda a: V3(*(torch.tensor(np.ascontiguousarray(a[:, i]))  # noqa
                        for i in range(3)))
    js, jrec, jemit = jshading.scatter_and_emit_v3(
        jnp.asarray(state.astype(np.uint32)), jscene,
        jtextures.TexFlags(*flags), jnp.asarray(rows), jv(p), jv(normal),
        jnp.asarray(front), jnp.asarray(u), jnp.asarray(v), jv(wrd))
    ts, trec, temit = shading.scatter_and_emit_v3(
        torch.tensor(state.astype(np.int64)), TexFlags(*flags),
        torch.tensor(rows), tv(p), tv(normal), torch.tensor(front), tv(wrd),
        scene=scene, hit_u=torch.tensor(u), hit_v=torch.tensor(v))
    np.testing.assert_array_equal(np.asarray(js).astype(np.int64),
                                  ts.numpy().astype(np.int64))
    for name in ("is_scattered", "mat_pdf_type", "skip_pdf"):
        np.testing.assert_array_equal(getattr(trec, name).numpy(),
                                      np.asarray(getattr(jrec, name)))
    for j, t in ((jrec.attenuation, trec.attenuation), (jemit, temit)):
        for a, b in zip(j, t):
            np.testing.assert_array_equal(b.numpy(), np.broadcast_to(
                np.asarray(a), b.shape))
    # The image slots took texels, not their zero base colour, in both
    # images.
    value = (temit if case == "emission" else trec.attenuation)
    read = front if case == "emission" else np.ones(N, bool)
    if case == "checker":
        even = textures.checker_is_even(torch.tensor(rows[:, 17]),
                                        tv(p)).numpy()
        read = np.where(even, rows[:, 24], rows[:, 26]) == MODE_IMAGE
    lum = value.x.numpy() + value.y.numpy() + value.z.numpy()
    assert (lum[read] > 0.0).mean() > 0.95
    assert read.sum() > N // 4


def test_prepare_batch_image_rows_match_jax(pngs):
    jcs = jax_compile_scene(JaxSceneFile.from_json_dict(
        image_scenes.image_mix_doc(pngs[0])), width=16)
    cs = arrays.from_jax_compiled(jcs)
    scene, static = arrays.upload_scene(cs, "cpu")
    static = dataclasses.replace(static, sphere_world_mode=True)
    assert static.flags.has_image and static.has_tris
    t = np.float32(0.37)
    tab = spheres.world_sphere_tables(cs, np.array([t], np.float32))[0]
    tris = wavefront.prepare_tris(static, scene, torch.tensor(t))
    geom = wavefront.prepare_batch(static, scene, torch.tensor(tab),
                                   tris=tris, batch_time=torch.tensor(t))
    jscene, jstatic = jarrays.upload_scene(jcs)
    jstatic = dataclasses.replace(jstatic, sphere_world_mode=True,
                                  use_pallas_sweep=True)
    jgeom = jwavefront.prepare_batch(jstatic, jscene, jnp.float32(t),
                                     sph_table=tab)
    rows = geom.prim_rows.numpy()
    np.testing.assert_array_equal(rows[:, 0:49],
                                  np.asarray(jgeom.prim_rows)[:, 0:49])
    s_pad = scene.sph_center.shape[0]
    att = np.asarray(jgeom.tri_attr16)
    T = cs.num_triangles
    np.testing.assert_array_equal(rows[s_pad:s_pad + T, 49:64],
                                  att[:T, 0:15])
    assert not rows[:s_pad, 49:64].any()
    with pytest.raises(ValueError, match="batch time"):
        wavefront.prepare_batch(static, scene, torch.tensor(tab), tris=tris)
