"""Fat-row shading (constant, checker, noise and image slots) and the no-light
NEE branch: the port against raytrace_tpu.ops.shading / .nee on identical
rows, RNG states and hit data (numpy-seeded).  Integer outputs and RNG
states match exactly; floats within atol=1e-5 (sin/cos and XLA's FMA
contraction move the last bits)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.engine.arrays import upload_scene as jax_upload
from raytrace_tpu.models import compile_scene as jax_compile_scene
from raytrace_tpu.models.compile import MAT_TYPE_DIFFUSE_LIGHT
from raytrace_tpu.models.shading_table import (MODE_CHECKER, MODE_IMAGE,
                                               MODE_NOISE)
from raytrace_tpu.ops import nee as jnee
from raytrace_tpu.ops import shading as jshading
from raytrace_tpu.ops import textures as jtextures
from raytrace_tpu.ops import vec3 as jvec3
from raytrace_tpu.scene_file import SceneFile
from raytrace_tpu_torch.cli import DEFAULT_SCENE
from raytrace_tpu_torch.engine.arrays import from_jax_scene
from raytrace_tpu_torch.ops import nee as tnee
from raytrace_tpu_torch.ops import shading as tshading
from raytrace_tpu_torch.ops.materials import (COSINE_PDF, LIGHT_PDF, NO_PDF,
                                              SPHERE_PDF)
from raytrace_tpu_torch.ops.textures import TexFlags
from raytrace_tpu_torch.ops.vec3 import V3
from raytrace_tpu_torch.tools.image_scenes import texel_ids

torch.set_num_threads(1)

ATOL = 1e-5
N = 4096


@pytest.fixture(scope="module")
def inputs():
    """Rows of final-one-weekend's primitives (carried across from the JAX
    scene arrays), a quarter turned into emitters with checker or constant
    emission, and random hit data."""
    cs = jax_compile_scene(SceneFile.load_json(DEFAULT_SCENE), width=96,
                           height=54)
    jscene, _ = jax_upload(cs)
    scene = from_jax_scene(jscene)
    g = np.random.default_rng(0)
    rows = scene.shade_rows.numpy()[g.integers(0, cs.num_spheres, N)].copy()
    light = g.random(N) < 0.25
    rows[light, 0] = MAT_TYPE_DIFFUSE_LIGHT
    rows[light, 8:11] = g.random((light.sum(), 3))
    rows[light, 15] = np.where(g.random(light.sum()) < 0.5, MODE_CHECKER, 0.0)
    normal = g.standard_normal((N, 3))
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    return dict(
        jscene=jscene, rows=rows.astype(np.float32),
        p=g.uniform(-12, 12, (N, 3)).astype(np.float32),
        normal=normal.astype(np.float32),
        front=g.random(N) < 0.5,
        wrd=(g.standard_normal((N, 3)) * 2.0).astype(np.float32),
        state=g.integers(0, 2 ** 32, N, dtype=np.uint64),
        pdf=g.choice([NO_PDF, SPHERE_PDF, COSINE_PDF], N).astype(np.int32),
    )


def _jv(a):
    return jvec3.V3(*(jnp.asarray(a[:, i]) for i in range(3)))


def _tv(a):
    return V3(*(torch.tensor(np.ascontiguousarray(a[:, i]))
                for i in range(3)))


def _close(j, t):
    for a, b in zip(j, t):
        np.testing.assert_allclose(b.numpy(), np.broadcast_to(
            np.asarray(a), b.shape), rtol=0, atol=ATOL)


def _exact(j, t):
    np.testing.assert_array_equal(
        np.asarray(j).astype(np.int64), t.numpy().astype(np.int64))


@pytest.mark.parametrize("has_checker,has_emissive",
                         [(True, True), (True, False), (False, True)])
def test_scatter_and_emit_v3(inputs, has_checker, has_emissive):
    x = inputs
    zeros = jnp.zeros(N, jnp.float32)
    js, jrec, jemit = jshading.scatter_and_emit_v3(
        jnp.asarray(x["state"].astype(np.uint32)), x["jscene"],
        jtextures.TexFlags(False, has_checker, False, has_emissive),
        jnp.asarray(x["rows"]), _jv(x["p"]), _jv(x["normal"]),
        jnp.asarray(x["front"]), zeros, zeros, _jv(x["wrd"]))
    ts, trec, temit = tshading.scatter_and_emit_v3(
        torch.tensor(x["state"].astype(np.int64)),
        TexFlags(False, has_checker, False, has_emissive),
        torch.tensor(x["rows"]), _tv(x["p"]), _tv(x["normal"]),
        torch.tensor(x["front"]), _tv(x["wrd"]))
    _exact(js, ts)
    for name in ("is_scattered", "mat_pdf_type", "skip_pdf"):
        _exact(getattr(jrec, name), getattr(trec, name))
    _close(jrec.attenuation, trec.attenuation)
    _close(jrec.skip_dir, trec.skip_dir)
    _close(jemit, temit)
    if has_emissive:
        assert float(temit.x.abs().sum()) > 0.0


def _noise_rows(rows, seed):
    """``rows`` with noise slots (ops/shading.py's three places a noise
    slot is read): a third of the albedo slots, the even side of every
    checker and half of the emission slots become noise of a random scale,
    their base rgb zero as the shading table writes it."""
    g = np.random.default_rng(seed)
    rows = rows.copy()
    n = len(rows)
    albedo = (g.random(n) < 1 / 3) & (rows[:, 11] == 0.0)
    rows[albedo, 11] = MODE_NOISE
    rows[albedo, 12] = g.uniform(0, 8, albedo.sum())
    rows[albedo, 2:5] = 0.0
    checker = rows[:, 11] == MODE_CHECKER
    rows[checker, 24], rows[checker, 25] = MODE_NOISE, 4.0
    rows[checker, 18:21] = 0.0
    emit = (rows[:, 0] == MAT_TYPE_DIFFUSE_LIGHT) & (g.random(n) < 0.5)
    rows[emit, 15], rows[emit, 16] = MODE_NOISE, g.uniform(0, 8, emit.sum())
    rows[emit, 8:11] = 0.0
    assert albedo.any() and checker.any() and emit.any()
    return rows


def _image_rows(rows, seed):
    """``rows`` with image slots: a third of the albedo slots and half of
    the emission slots become image 0, their base rgb zero as the shading
    table writes it."""
    g = np.random.default_rng(seed)
    rows = rows.copy()
    n = len(rows)
    albedo = (g.random(n) < 1 / 3) & (rows[:, 11] == 0.0)
    rows[albedo, 11], rows[albedo, 12] = MODE_IMAGE, 0.0
    rows[albedo, 2:5] = 0.0
    emit = (rows[:, 0] == MAT_TYPE_DIFFUSE_LIGHT) & (g.random(n) < 0.5)
    rows[emit, 15], rows[emit, 16] = MODE_IMAGE, 0.0
    rows[emit, 8:11] = 0.0
    assert albedo.any() and emit.any()
    return rows


def _with_atlas(jscene):
    """The JAX scene arrays with a 64x32 texel-id image as their atlas."""
    atlas = texel_ids(64, 32)[None]
    return jscene._replace(atlas=jnp.asarray(atlas),
                           atlas_wh=jnp.asarray([[64, 32]], jnp.int32))


def _scatter_both(x, rows, flags, jscene=None, uv=None):
    if uv is None:
        uv = np.zeros((2, N), np.float32)
    jscene = x["jscene"] if jscene is None else jscene
    jout = jshading.scatter_and_emit_v3(
        jnp.asarray(x["state"].astype(np.uint32)), jscene,
        jtextures.TexFlags(*flags), jnp.asarray(rows), _jv(x["p"]),
        _jv(x["normal"]), jnp.asarray(x["front"]), jnp.asarray(uv[0]),
        jnp.asarray(uv[1]), _jv(x["wrd"]))
    tout = tshading.scatter_and_emit_v3(
        torch.tensor(x["state"].astype(np.int64)), flags, torch.tensor(rows),
        _tv(x["p"]), _tv(x["normal"]), torch.tensor(x["front"]), _tv(x["wrd"]),
        scene=from_jax_scene(jscene), hit_u=torch.tensor(uv[0]),
        hit_v=torch.tensor(uv[1]))
    return jout, tout


@pytest.mark.parametrize("flags", [TexFlags(True, False, False),
                                   TexFlags(False, True, True)])
def test_image_and_noise_textures_raise(inputs, flags):
    """Neither texture family raises any more: both are ported.  With image
    slots in the rows (the albedo and the emission of a scene whose atlas
    is a texel-id image, at random UVs) or noise slots (albedo, a checker's
    side, emission), the port's scatter_and_emit_v3 matches JAX's (floats
    within ATOL; an image slot's colour is the same table entry on both
    sides; the marble of the same hit point is the same turbulence on both
    sides, and each side's sin rounds on its own)."""
    x = inputs
    if flags.has_image:
        rows = _image_rows(x["rows"], seed=2)
        uv = np.random.default_rng(3).uniform(-1.5, 2.5, (2, N)).astype(
            np.float32)
        (js, jrec, jemit), (ts, trec, temit) = _scatter_both(
            x, rows, flags, _with_atlas(x["jscene"]), uv)
        mode = MODE_IMAGE
    else:
        rows = _noise_rows(x["rows"], seed=1)
        (js, jrec, jemit), (ts, trec, temit) = _scatter_both(x, rows, flags)
        mode = MODE_NOISE
    _exact(js, ts)
    for name in ("is_scattered", "mat_pdf_type", "skip_pdf"):
        _exact(getattr(jrec, name), getattr(trec, name))
    _close(jrec.attenuation, trec.attenuation)
    _close(jemit, temit)
    # The image or noise slots took texels or the marble, not their zero
    # base colour (a texel is dark in all three channels only at one of the
    # image's 2048 texels).
    lum = lambda v: v.x.numpy() + v.y.numpy() + v.z.numpy()  # noqa: E731
    lamb = (rows[:, 0] == 1) & (rows[:, 11] == mode)
    assert (lum(trec.attenuation)[lamb] > 0.0).mean() > 0.99
    light = ((rows[:, 0] == MAT_TYPE_DIFFUSE_LIGHT)
             & (rows[:, 15] == mode) & x["front"])
    assert (lum(temit)[light] > 0.0).mean() > 0.99


def test_no_light_nee(inputs):
    x = inputs
    js, jchosen = jnee.choose_mixture_pdf(
        jnp.asarray(x["state"].astype(np.uint32)), jnp.asarray(x["pdf"]),
        False)
    ts, tchosen = tnee.choose_mixture_pdf(
        torch.tensor(x["state"].astype(np.int64)), torch.tensor(x["pdf"]),
        False)
    _exact(js, ts)
    _exact(jchosen, tchosen)

    jzero = jvec3.zeros_like(_jv(x["p"]))
    jlight = jnee.LightSampleV3(position=jzero, normal=jzero)
    tzero = V3(*(torch.zeros(N) for _ in range(3)))
    tlight = tnee.LightSampleV3(position=tzero, normal=tzero)
    js, jdir = jnee.gen_scatter_direction_v3(js, jchosen, _jv(x["p"]),
                                             _jv(x["normal"]), jlight)
    ts, tdir = tnee.gen_scatter_direction_v3(ts, tchosen, _tv(x["p"]),
                                             _tv(x["normal"]), tlight)
    _exact(js, ts)
    _close(jdir, tdir)

    jpdf = jnee.pdf_value_v3(jnp.asarray(x["pdf"]), jdir, _jv(x["normal"]),
                             jlight, jnp.float32(1.0))
    tpdf = tnee.pdf_value_v3(torch.tensor(x["pdf"]), tdir, _tv(x["normal"]),
                             tlight, 1.0)
    _close([jpdf], [tpdf])
    np.testing.assert_array_equal(np.asarray(jpdf) > 0, tpdf.numpy() > 0)

    for a, b in zip(jnee.make_onb_v3(_jv(x["wrd"])),
                    tnee.make_onb_v3(_tv(x["wrd"]))):
        _close(a, b)


def test_nee_with_lights_raises(inputs):
    """NEE with lights is ported: the mixture choice no longer raises, it
    draws once and picks the light pdf where r < 0.5, as JAX does, and
    the light pdf of a direction matches JAX's (tests/test_torch_nee.py
    holds the light sample)."""
    x = inputs
    js, jchosen = jnee.choose_mixture_pdf(
        jnp.asarray(x["state"].astype(np.uint32)), jnp.asarray(x["pdf"]),
        True)
    ts, tchosen = tnee.choose_mixture_pdf(
        torch.tensor(x["state"].astype(np.int64)), torch.tensor(x["pdf"]),
        True)
    _exact(js, ts)
    _exact(jchosen, tchosen)
    assert not torch.equal(ts, torch.tensor(x["state"].astype(np.int64)))
    assert (tchosen == LIGHT_PDF).any() and (tchosen != LIGHT_PDF).any()
    light = jnee.LightSampleV3(position=_jv(x["p"]), normal=_jv(x["normal"]))
    tlight = tnee.LightSampleV3(position=_tv(x["p"]), normal=_tv(x["normal"]))
    jpdf = jnee.pdf_value_v3(jchosen, _jv(x["wrd"]), _jv(x["normal"]), light,
                             jnp.float32(13650.0))
    tpdf = tnee.pdf_value_v3(tchosen, _tv(x["wrd"]), _tv(x["normal"]),
                             tlight, torch.tensor(13650.0))
    np.testing.assert_allclose(tpdf.numpy(), np.asarray(jpdf), rtol=1e-5,
                               atol=ATOL)
