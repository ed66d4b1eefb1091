"""Fat-row shading and the no-light NEE branch: the port against
raytrace_tpu.ops.shading / .nee on identical rows, RNG states and hit data
(numpy-seeded).  Integer outputs and RNG states match exactly; floats within
atol=1e-5 (sin/cos and XLA's FMA contraction move the last bits)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.engine.arrays import upload_scene as jax_upload
from raytrace_tpu.models.compile import MAT_TYPE_DIFFUSE_LIGHT
from raytrace_tpu.models.shading_table import MODE_CHECKER
from raytrace_tpu.ops import nee as jnee
from raytrace_tpu.ops import shading as jshading
from raytrace_tpu.ops import textures as jtextures
from raytrace_tpu.ops import vec3 as jvec3
from raytrace_tpu_torch.cli import DEFAULT_SCENE, load_scene
from raytrace_tpu_torch.engine.arrays import from_jax_scene
from raytrace_tpu_torch.ops import nee as tnee
from raytrace_tpu_torch.ops import shading as tshading
from raytrace_tpu_torch.ops.materials import COSINE_PDF, NO_PDF, SPHERE_PDF
from raytrace_tpu_torch.ops.textures import TexFlags
from raytrace_tpu_torch.ops.vec3 import V3

torch.set_num_threads(1)

ATOL = 1e-5
N = 4096


@pytest.fixture(scope="module")
def inputs():
    """Rows of final-one-weekend's primitives (carried across from the JAX
    scene arrays), a quarter turned into emitters with checker or constant
    emission, and random hit data."""
    cs = load_scene(DEFAULT_SCENE, 96, 54)
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


@pytest.mark.parametrize("flags", [TexFlags(True, False, False),
                                   TexFlags(False, False, True)])
def test_image_and_noise_textures_raise(inputs, flags):
    x = inputs
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tshading.scatter_and_emit_v3(
            torch.tensor(x["state"].astype(np.int64)), flags,
            torch.tensor(x["rows"]), _tv(x["p"]), _tv(x["normal"]),
            torch.tensor(x["front"]), _tv(x["wrd"]))


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
    with pytest.raises(NotImplementedError, match="NEE with lights"):
        tnee.choose_mixture_pdf(torch.zeros(4, dtype=torch.int64),
                                torch.zeros(4, dtype=torch.int32), True)
