"""Camera matrices (bitwise) and primary rays (atol=1e-5) of the port
against raytrace_tpu.ops.camera, on final-one-weekend's camera."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.ops import camera as jcam
from raytrace_tpu_torch.cli import DEFAULT_SCENE, load_scene
from raytrace_tpu_torch.ops import camera as tcam

torch.set_num_threads(1)

RAY_ATOL = 1e-5
W, H, SQRT_SPP = 96, 54, 2


@pytest.fixture(scope="module")
def params():
    return load_scene(DEFAULT_SCENE, W, H).cameras["default"]


def test_camera_matrices_bitwise(params):
    fov = math.radians(params.fov_y_deg)
    np.testing.assert_array_equal(
        tcam.perspective_rh(fov, W / H, params.z_near, params.z_far),
        jcam.perspective_rh(fov, W / H, params.z_near, params.z_far))
    args = (params.eye, np.asarray(params.look_at, np.float64),
            np.asarray(params.up, np.float64))
    np.testing.assert_array_equal(tcam.look_at_rh(*args),
                                  jcam.look_at_rh(*args))
    jc = jcam.build_camera_arrays(params, W, H)
    tc = tcam.build_camera_arrays(params, W, H, "cpu")
    for a, b in zip(jc, tc):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("use_dof", [False, True])
def test_get_rays_v3(params, use_dof):
    g = np.random.default_rng(7)
    n = 8192
    px, py = g.integers(0, W, n), g.integers(0, H, n)
    si, sj = g.integers(0, SQRT_SPP, n), g.integers(0, SQRT_SPP, n)
    state = g.integers(0, 2 ** 32, n, dtype=np.uint64)
    js, jo, jd = jcam.get_rays_v3(
        jnp.asarray(state.astype(np.uint32)),
        jcam.build_camera_arrays(params, W, H),
        *(jnp.asarray(a, jnp.int32) for a in (px, py, si, sj)),
        W, H, SQRT_SPP, use_dof=use_dof)
    ts, to, td = tcam.get_rays_v3(
        torch.tensor(state.astype(np.int64)),
        tcam.build_camera_arrays(params, W, H, "cpu"),
        *(torch.tensor(a) for a in (px, py, si, sj)),
        W, H, SQRT_SPP, use_dof=use_dof)
    np.testing.assert_array_equal(np.asarray(js).astype(np.int64), ts.numpy())
    for a, b in zip((*jo, *jd), (*to, *td)):
        np.testing.assert_allclose(b.numpy(), np.broadcast_to(np.asarray(a), b.shape),
                                   rtol=0, atol=RAY_ATOL)
