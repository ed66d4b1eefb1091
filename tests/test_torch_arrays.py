"""Host-side state of the port, bitwise against the JAX package: uploaded
scene arrays, the JAX-to-port carry-over, texture flags, the sRGB table,
batch times and the per-batch fat rows (the kernel table is checked in
test_torch_sphere_sweep.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.engine import arrays as jarrays
from raytrace_tpu.engine import renderer as jrenderer
from raytrace_tpu.engine import wavefront as jwavefront
from raytrace_tpu.models import compile_scene as jax_compile_scene
from raytrace_tpu.ops import spheres as jspheres
from raytrace_tpu.ops import textures as jtextures
from raytrace_tpu.scene_file import SceneFile
from raytrace_tpu_torch.cli import DEFAULT_SCENE
from raytrace_tpu_torch.engine import arrays as tarrays
from raytrace_tpu_torch.engine import renderer as trenderer
from raytrace_tpu_torch.engine import wavefront as twavefront
from raytrace_tpu_torch.ops import textures as ttextures

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene():
    """(the port's CompiledScene, the JAX scene arrays and static, the
    JAX CompiledScene it was carried over from)."""
    jcs = jax_compile_scene(SceneFile.load_json(DEFAULT_SCENE), width=96,
                            height=54)
    jscene, jstatic = jarrays.upload_scene(jcs)
    return tarrays.from_jax_compiled(jcs), jscene, jstatic, jcs


def _equal(j, t):
    j = np.asarray(j)
    assert t.numpy().dtype == j.dtype
    np.testing.assert_array_equal(t.numpy(), j)


def test_upload_scene_and_from_jax_scene_bitwise(scene):
    cs, jscene, jstatic, _ = scene
    tscene, tstatic = tarrays.upload_scene(cs, "cpu")
    carried = tarrays.from_jax_scene(jscene)
    assert tarrays.SceneArrays._fields == jarrays.SceneArrays._fields
    for name in tarrays.SceneArrays._fields:
        _equal(getattr(jscene, name), getattr(tscene, name))
        _equal(getattr(jscene, name), getattr(carried, name))
    for f in dataclasses.fields(tstatic):
        assert getattr(tstatic, f.name) == getattr(jstatic, f.name), f.name


def test_texflags_and_srgb_lut_bitwise(scene):
    cs, jcs = scene[0], scene[3]
    assert tuple(ttextures.TexFlags.for_scene(cs)) == tuple(
        jtextures.TexFlags.for_scene(jcs))
    np.testing.assert_array_equal(ttextures.srgb_u8_to_linear_lut(),
                                  jtextures.srgb_u8_to_linear_lut())


@pytest.mark.parametrize("batches", [1, 25, 64])
def test_batch_ray_times_bitwise(batches):
    np.testing.assert_array_equal(trenderer.get_batch_ray_times(batches),
                                  jrenderer.get_batch_ray_times(batches))


def test_prepare_batch_bitwise(scene):
    cs, jscene, jstatic, jcs = scene
    tab = jspheres.world_sphere_tables(jcs, [0.5])[0]
    jst = dataclasses.replace(jstatic, sphere_world_mode=True)
    jgeom = jwavefront.prepare_batch(jst, jscene, jnp.float32(0.5),
                                     sph_table=tab)
    tscene, tstatic = tarrays.upload_scene(cs, "cpu")
    tgeom = twavefront.prepare_batch(tstatic, tscene, torch.tensor(tab))
    _equal(jgeom.prim_rows, tgeom.prim_rows)
