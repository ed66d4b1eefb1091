"""Instance transforms of the port (ops/transforms.py) against the JAX
package's (raytrace_tpu/ops/transforms.py) on the same inputs, made from a
numpy seed: random TRS pairs whose quaternions take both branches of the
slerp (nearly parallel: the normalised lerp; apart: the arccos/sin form,
with and without the shortest-path flip), and random soups moved to world
space with them.  Tolerance: 1e-6 relative (atol 1e-6), for the arccos and
sin of the slerp and the einsum sums, which XLA and PyTorch may round
differently; the branch each quaternion takes must agree exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.ops import transforms as jtransforms
from raytrace_tpu_torch.ops import transforms

torch.set_num_threads(1)

RTOL = ATOL = 1e-6


def _quat(g, n):
    q = g.standard_normal((n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _trs_pairs(seed, n=24):
    """[n, 10] TRS rows at t0 and t1: a third nearly parallel
    (|q0.q1| > 0.9995), a third apart, a third apart with q0.q1 < 0."""
    g = np.random.default_rng(seed)
    q0 = _quat(g, n)
    q1 = _quat(g, n)
    third = n // 3
    q1[:third] = q0[:third] + 1e-3 * g.standard_normal((third, 4))
    q1[:third] /= np.linalg.norm(q1[:third], axis=1, keepdims=True)
    dots = (q0 * q1).sum(1)
    q1[third:2 * third] *= np.sign(dots[third:2 * third])[:, None]
    q1[2 * third:] *= -np.sign(dots[2 * third:])[:, None]
    t0 = np.concatenate([g.uniform(-5, 5, (n, 3)), q0,
                         g.uniform(0.5, 2.0, (n, 3))], 1)
    t1 = np.concatenate([g.uniform(-5, 5, (n, 3)), q1,
                         g.uniform(0.5, 2.0, (n, 3))], 1)
    return t0.astype(np.float32), t1.astype(np.float32)


def _close(j, t):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("time", [0.0, 0.37, 1.0])
def test_slerp_and_matrices_match_jax(seed, time):
    t0, t1 = _trs_pairs(seed)
    dots = np.abs((t0[:, 3:7] * t1[:, 3:7]).sum(1))
    assert (dots > 0.9995).any() and (dots < 0.9995).any()
    tm = np.float32(time)
    _close(jtransforms.quat_slerp(jnp.asarray(t0[:, 3:7]),
                                  jnp.asarray(t1[:, 3:7]), tm),
           transforms.quat_slerp(torch.tensor(t0[:, 3:7]),
                                 torch.tensor(t1[:, 3:7]), torch.tensor(tm)))
    _close(jtransforms.quat_to_mat3(jnp.asarray(t0[:, 3:7])),
           transforms.quat_to_mat3(torch.tensor(t0[:, 3:7])))
    jm = jtransforms.interpolate_instances(jnp.asarray(t0), jnp.asarray(t1),
                                           jnp.float32(time))
    tmats = transforms.interpolate_instances(torch.tensor(t0),
                                             torch.tensor(t1),
                                             torch.tensor(tm))
    _close(jm.object_to_world, tmats.object_to_world)
    _close(jm.world_to_object, tmats.world_to_object)


def test_static_instances_stay_put():
    """t1 == t0: every batch time gives the same matrices to within the
    slerp's normalisation, and the inverse undoes the forward map."""
    t0, _ = _trs_pairs(3)
    for tm in (0.0, 0.5, 1.0):
        m = transforms.interpolate_instances(torch.tensor(t0),
                                             torch.tensor(t0),
                                             torch.tensor(np.float32(tm)))
        fwd = torch.cat([m.object_to_world,
                         torch.tensor([[[0, 0, 0, 1.0]]]).expand(
                             len(t0), 1, 4)], 1)
        inv = torch.cat([m.world_to_object,
                         torch.tensor([[[0, 0, 0, 1.0]]]).expand(
                             len(t0), 1, 4)], 1)
        eye = torch.eye(4).expand(len(t0), 4, 4)
        torch.testing.assert_close(inv @ fwd, eye, rtol=0, atol=1e-5)


@pytest.mark.parametrize("time", [0.0, 0.61])
def test_transform_soup_matches_jax(time):
    t0, t1 = _trs_pairs(7, n=9)
    g = np.random.default_rng(11)
    T = 300
    tri_p = g.uniform(-2, 2, (T, 3, 3)).astype(np.float32)
    tri_n = g.standard_normal((T, 3, 3)).astype(np.float32)
    tri_inst = g.integers(0, len(t0), T).astype(np.int32)
    jm = jtransforms.interpolate_instances(jnp.asarray(t0), jnp.asarray(t1),
                                           jnp.float32(time))
    jp, jn = jtransforms.transform_soup(jnp.asarray(tri_p),
                                        jnp.asarray(tri_n),
                                        jnp.asarray(tri_inst), jm)
    # The same matrices on both sides: the soup transform alone.
    tm = transforms.InstanceMatrices(
        torch.tensor(np.asarray(jm.object_to_world)),
        torch.tensor(np.asarray(jm.world_to_object)))
    tp, tn = transforms.transform_soup(torch.tensor(tri_p),
                                       torch.tensor(tri_n),
                                       torch.tensor(tri_inst), tm)
    _close(jp, tp)
    _close(jn, tn)
    # Normals are left unnormalised (shading normalises after the lerp).
    assert not torch.allclose(tn.norm(dim=-1), torch.ones(T, 3))
