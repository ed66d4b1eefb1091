"""The port's numpy host layers (raytrace_tpu_torch/scene_file, models,
tools/chacha.py, utils/image.py) against the JAX package's modules they
were copied from: compiled scenes field by field (arrays np.array_equal,
scalars and records equal), scene JSON round trips, the host RNG word for
word, sRGB and PNG bytes, and the carry-over of a JAX CompiledScene."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from raytrace_tpu.models import bvh_build as jbvh_build
from raytrace_tpu.models import compile_scene as jax_compile_scene
from raytrace_tpu.scene_file import SceneFile as JaxSceneFile
from raytrace_tpu.tools.chacha import ChaCha20Rng as JaxChaCha20Rng
from raytrace_tpu.utils import image as jimage
from raytrace_tpu_torch import cli
from raytrace_tpu_torch.engine import arrays
from raytrace_tpu_torch.models import bvh_build, compile_scene
from raytrace_tpu_torch.models.compile import CompiledScene
from raytrace_tpu_torch.scene_file import SceneFile
from raytrace_tpu_torch.tools import image_scenes
from raytrace_tpu_torch.tools.chacha import ChaCha20Rng
from raytrace_tpu_torch.utils import image

torch.set_num_threads(1)

ASSETS = os.path.dirname(cli.DEFAULT_SCENE)
SCENES = ["final-one-weekend.json", "final-one-weekend-motion-blur.json"]


def _assert_same(j, t, where="cs"):
    """The JAX package's value j and the port's t agree: records field by
    field, containers item by item, arrays bit for bit with one dtype."""
    if dataclasses.is_dataclass(j):
        assert type(t).__name__ == type(j).__name__, where
        names = [f.name for f in dataclasses.fields(j)]
        assert [f.name for f in dataclasses.fields(t)] == names, where
        for name in names:
            _assert_same(getattr(j, name), getattr(t, name), f"{where}.{name}")
    elif isinstance(j, dict):
        assert list(t) == list(j), where
        for k in j:
            _assert_same(j[k], t[k], f"{where}[{k!r}]")
    elif isinstance(j, (list, tuple)):
        assert type(t) is type(j) and len(t) == len(j), where
        for i, (a, b) in enumerate(zip(j, t)):
            _assert_same(a, b, f"{where}[{i}]")
    elif isinstance(j, np.ndarray):
        assert isinstance(t, np.ndarray), where
        assert t.dtype == j.dtype and t.shape == j.shape, where
        assert np.array_equal(t, j, equal_nan=j.dtype.kind == "f"), where
    else:
        assert type(t) is type(j) and t == j, (where, j, t)


@pytest.fixture(scope="module")
def png(tmp_path_factory):
    """A 48x24 texel-id image (tools/image_scenes.py) for the image
    texture of _feature_doc."""
    return image_scenes.texel_id_png(
        str(tmp_path_factory.mktemp("maps") / "map.png"), 48, 24)


def _feature_doc(png):
    """Every family compile_scene handles apart from OBJ files: quads, a
    box, a triangle, a checker (whose odd side is an image), a noise
    texture, an image texture (``png``), a diffuse light, metal and
    dielectric, a moving and a rotated instance."""
    cam = json.load(open(cli.DEFAULT_SCENE))["cameras"]
    quad = lambda name, y, mat: {"quad": {  # noqa: E731
        "name": name, "points": [[-1, y, -1], [1, y, -1], [1, y, 1],
                                 [-1, y, 1]],
        "normal": [0, 1, 0], "uv": [[0, 0], [1, 0], [1, 1], [0, 1]],
        "material": mat}}
    return {
        "cameras": cam,
        "textures": [
            {"constant": {"name": "white", "rgb": [0.8, 0.8, 0.8]}},
            {"constant": {"name": "red", "rgb": [0.7, 0.1, 0.1]}},
            {"constant": {"name": "fuzz", "rgb": [0.2, 0.2, 0.2]}},
            {"checker": {"name": "check", "scale": 0.5, "even": "white",
                         "odd": "map"}},
            {"noise": {"name": "marble", "scale": 4.0}},
            {"image": {"name": "map", "path": png}},
        ],
        "materials": [
            {"lambertian": {"name": "plain", "albedo": "white"}},
            {"lambertian": {"name": "checked", "albedo": "check"}},
            {"lambertian": {"name": "noisy", "albedo": "marble"}},
            {"lambertian": {"name": "mapped", "albedo": "map"}},
            {"metal": {"name": "steel", "albedo": "red", "fuzz": "fuzz"}},
            {"dielectric": {"name": "glass", "refraction_index": 1.5}},
            {"diffuse_light": {"name": "lamp", "emit": "white"}},
        ],
        "primitives": [
            {"uv_sphere": {"name": "ball", "center": [0, -1, 0],
                           "radius": 1.0, "rings": 8, "segments": 16,
                           "material": "glass"}},
            {"uv_sphere": {"name": "marble", "center": [3, -1, 0],
                           "radius": 1.0, "rings": 8, "segments": 16,
                           "material": "noisy"}},
            {"uv_sphere": {"name": "globe", "center": [-3, -1, 0],
                           "radius": 1.0, "rings": 8, "segments": 16,
                           "material": "mapped"}},
            {"triangle": {"name": "tri", "points": [[0, 0, 0], [1, 0, 0],
                                                    [0, 1, 0]],
                          "normal": [0, 0, 1],
                          "uv": [[0, 0], [1, 0], [0, 1]],
                          "material": "steel"}},
            quad("floor", 0.0, "checked"),
            quad("lamp", -4.0, "lamp"),
            {"box": {"name": "crate", "corners": [[-3, -1, -3], [-2, 0, -2]],
                     "material": "plain"}},
        ],
        "instances": [
            {"name": "ball", "transform": {"animated": [
                {"translate": [0, 0, 0]}, {"translate": [0, -0.5, 0.2]}]}},
            {"name": "marble"},
            {"name": "globe"},
            {"name": "tri", "transform": {"static": {
                "rotate": {"axis": [0, 1, 0], "degrees": 30.0}}}},
            {"name": "floor", "transform": {"static": {"scale": [4, 1, 4]}}},
            {"name": "lamp"},
            {"name": "crate"},
        ],
        "sky": {"vertical_gradient": {"factor": 0.5, "top": [0.5, 0.7, 1.0],
                                      "bottom": [1.0, 1.0, 1.0]}},
        "render": {"camera": "default", "samples_per_pixel": 4,
                   "sample_batches": 2, "max_ray_depth": 4,
                   "aspect_ratio": 16 / 9},
    }


def _both(source, width, height):
    """(JAX CompiledScene, the port's) of one scene file or JSON doc."""
    if isinstance(source, dict):
        jsf, tsf = (JaxSceneFile.from_json_dict(source),
                    SceneFile.from_json_dict(source))
    else:
        path = os.path.join(ASSETS, source)
        jsf, tsf = JaxSceneFile.load_json(path), SceneFile.load_json(path)
    tsf.validate()
    return (jax_compile_scene(jsf, width=width, height=height),
            compile_scene(tsf, width=width, height=height))


@pytest.mark.parametrize("size", [(32, 18), (96, 54)])
@pytest.mark.parametrize("name", SCENES)
def test_compile_scene_matches_jax(name, size):
    jcs, cs = _both(name, *size)
    assert isinstance(cs, CompiledScene)
    _assert_same(jcs, cs)


def test_compile_scene_matches_jax_on_every_feature(png):
    jcs, cs = _both(_feature_doc(png), 48, 27)
    assert cs.num_triangles > 0 and cs.light_count > 0 and cs.any_animated
    assert cs.noise_scale.any() and cs.checker_scale.any()
    # The image: its atlas bytes and size as the JAX package decodes them.
    assert cs.atlas.shape == (1, 24, 48, 3) and cs.atlas.dtype == np.uint8
    np.testing.assert_array_equal(cs.atlas, jcs.atlas)
    np.testing.assert_array_equal(cs.atlas_wh, jcs.atlas_wh)
    assert tuple(cs.atlas_wh[0]) == (48, 24)
    _assert_same(jcs, cs)


@pytest.mark.parametrize("source", SCENES + ["features"])
def test_scene_file_json_round_trip_matches_jax(source, png):
    if source == "features":
        doc = _feature_doc(png)
    else:
        doc = json.load(open(os.path.join(ASSETS, source)))
    jdoc = JaxSceneFile.from_json_dict(doc).to_json_dict()
    tdoc = SceneFile.from_json_dict(doc).to_json_dict()
    assert json.dumps(tdoc, sort_keys=True) == json.dumps(jdoc, sort_keys=True)
    again = SceneFile.from_json_dict(tdoc).to_json_dict()
    assert json.dumps(again, sort_keys=True) == json.dumps(tdoc, sort_keys=True)


@pytest.mark.parametrize("seed", [0, 485_674_845_675_491])
def test_chacha20_streams_match_jax(seed):
    a, b = ChaCha20Rng.seed_from_u64(seed), JaxChaCha20Rng.seed_from_u64(seed)
    assert [a.next_u32() for _ in range(300)] == [b.next_u32()
                                                 for _ in range(300)]
    assert [a.f32_range(-0.5, 0.5) for _ in range(50)] == [
        b.f32_range(-0.5, 0.5) for _ in range(50)]
    assert a.vec3_in_range(-1.0, 1.0) == b.vec3_in_range(-1.0, 1.0)


def test_linear_to_srgb_and_png_bytes_match_jax(tmp_path):
    g = np.random.default_rng(0)
    img = g.uniform(-0.2, 1.4, (9, 16, 3)).astype(np.float32)
    img[0, :4, 0] = [0.0, 0.0031308, 1.0, 0.5]   # the curve's corners
    np.testing.assert_array_equal(image.linear_to_srgb(img),
                                  jimage.linear_to_srgb(img))
    image.write_png(str(tmp_path / "port.png"), img)
    jimage.write_png(str(tmp_path / "jax.png"), img)
    assert ((tmp_path / "port.png").read_bytes()
            == (tmp_path / "jax.png").read_bytes())


def test_instance_motion_matches_jax():
    jcs, cs = _both(SCENES[1], 32, 18)
    for t in (0.0, 0.37, 1.0):
        np.testing.assert_array_equal(
            bvh_build._instance_matrix_at(cs.inst_t0, cs.inst_t1, t),
            jbvh_build._instance_matrix_at(jcs.inst_t0, jcs.inst_t1, t))


def test_from_jax_compiled_round_trips(png):
    jcs, cs = _both(_feature_doc(png), 32, 18)
    carried = arrays.from_jax_compiled(jcs)
    assert isinstance(carried, CompiledScene)
    assert type(carried.render) is type(cs.render)
    assert all(type(c) is type(cs.cameras["default"])
               for c in carried.cameras.values())
    _assert_same(jcs, carried)
    _assert_same(cs, carried)
    # A copy: the JAX scene's arrays are not shared.
    assert not np.shares_memory(carried.sph_center, jcs.sph_center)
    assert arrays.from_jax_compiled(carried) is not carried


def test_upload_scene_takes_only_the_ports_compiled_scene():
    jcs, cs = _both(SCENES[0], 16, 9)
    with pytest.raises(TypeError, match="from_jax_compiled"):
        arrays.upload_scene(jcs, "cpu")
    scene, static = arrays.upload_scene(cs, "cpu")
    assert static.num_spheres == 488 and scene.sph_center.dtype == torch.float32
