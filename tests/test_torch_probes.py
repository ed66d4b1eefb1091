"""The dev probes P1-P3 of the port (raytrace_tpu_torch/tools_dev/) against
the JAX package's probes in tools_dev/, which run here in Pallas interpret
mode on the CPU; the JAX probes are imported by path under their own
module names and nothing in tools_dev/ is edited.

- P1 (probe_pallas.py): ``main`` with ``run`` replaced by a recorder that
  runs each kernel in interpret mode; each of the port's ten plain
  versions on the recorded inputs equals JAX's output bit for bit, except
  smem-scalar-loop (XLA's CPU build contracts its acc + c * x into an FMA
  and torch does not: within SMEM_RTOL; measured 2.0e-7), and sin+cos and
  pow-exp-log (XLA's and torch's CPU sin, cos, exp and log are different
  approximations, each within an ulp: within TRANSCENDENTAL_ATOL, 4 ulps
  of 1.0; measured 1.2e-7 and 2.4e-7).
- P2 (probe_trig.py): its kernel in interpret mode against the port's
  plain version, within TRIG_ULPS (XLA's CPU atan2 and acos against
  torch's; measured 2 ulps, on 330 of the 1,024 points).
- P3 (micro_raygen.py): its kernel in interpret mode with ITERS = 3, for
  the three variants, against the port's plain loop; the PCG state of
  every cell after every iteration is bit for bit with JAX's rng and
  camera functions run on the same inputs, and the float32 sum (up to
  ~4.8) is within RAYGEN_ATOL (XLA contracts the camera's multiply-adds;
  measured 4.8e-7 to 9.5e-7).

Also: the kernel library's hash covers the headers in csrc/, K4 and P3
include the same raygen header, and each probe's ``main`` runs with
``--device cpu`` (and raises without a card otherwise).  Card-only cases
are in tests/test_torch_cuda.py.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from raytrace_tpu.ops import camera as jcamera
from raytrace_tpu.ops import rng as jrng
from raytrace_tpu_torch.ops import _build
from raytrace_tpu_torch.tools_dev import _common
from raytrace_tpu_torch.tools_dev import micro_raygen as mr
from raytrace_tpu_torch.tools_dev import probe_ops, probe_trig

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
SMEM_RTOL = 1e-6
TRANSCENDENTAL_ATOL = 4 * 2.0 ** -23
TRIG_ULPS = 4
RAYGEN_ATOL = 4e-6


def _jax_probe(name: str):
    """tools_dev/<name>.py, imported by path as its own module."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_tools_dev_{name}", REPO / "tools_dev" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def p1_recorded():
    """{probe: (inputs, JAX output)} of probe_pallas.main in interpret
    mode."""
    mod = _jax_probe("probe_pallas")
    recorded = {}

    def record(name, kernel, inputs, out_shape, expect_fn=None, **kw):
        out = pl.pallas_call(kernel, out_shape=out_shape, interpret=True,
                             **kw)(*inputs)
        recorded[name] = ([np.asarray(a) for a in inputs], np.asarray(out))
        return True

    mod.run = record
    np.random.seed(0)
    mod.main()
    return recorded


def _port_args(name, inputs):
    """The port's (x, tab) for a probe from the JAX probe's inputs."""
    t = [torch.tensor(a.view(np.int32) if a.dtype == np.uint32 else a)
         for a in inputs]
    if name == "onehot-fetch":        # [rows_t, prim]
        return t[1], t[0]
    if len(t) == 2:                   # [tab, x]
        return t[1], t[0]
    return t[0], None


def test_p1_records_every_probe(p1_recorded):
    assert list(p1_recorded) == list(probe_ops.PROBES)


@pytest.mark.parametrize("name", probe_ops.PROBES)
def test_p1_plain_matches_jax_interpret(p1_recorded, name):
    inputs, want = p1_recorded[name]
    got = probe_ops.probe(name, *_port_args(name, inputs))
    assert got.shape == want.shape and got.dtype == torch.float32
    want = torch.tensor(want)
    if name in probe_ops.TRANSCENDENTAL:
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=TRANSCENDENTAL_ATOL)
    elif name == "smem-scalar-loop":
        torch.testing.assert_close(got, want, rtol=SMEM_RTOL, atol=0)
    else:
        assert torch.equal(got, want)


def test_p1_inputs_are_the_jax_probes(p1_recorded):
    inp = probe_ops.make_inputs("cpu")
    (x,), _ = p1_recorded["sin+cos"]
    (u,), _ = p1_recorded["pcg-rng"]
    (rows_t, prim), _ = p1_recorded["onehot-fetch"]
    (tab, _), _ = p1_recorded["smem-scalar-loop"]
    # numpy's float32 linspace, which rounds a few points otherwise than
    # jnp.linspace: within an ulp of the range's end.
    np.testing.assert_allclose(inp.x.numpy(), x, rtol=0, atol=2.0 ** -21)
    assert np.array_equal(inp.u.numpy(), u.view(np.int32))
    for port, jax_in in ((inp.rows_t, rows_t), (inp.prim, prim),
                         (inp.tab, tab)):
        assert port.shape == jax_in.shape and port.dtype == torch.tensor(
            jax_in).dtype


def test_p1_wrapper_rejects_bad_inputs():
    inp = probe_ops.make_inputs("cpu")
    with pytest.raises(ValueError, match="no probe"):
        probe_ops.probe("nope", inp.x)
    with pytest.raises(ValueError, match="int32"):
        probe_ops.probe("pcg-rng", inp.x)
    with pytest.raises(ValueError, match="needs"):
        probe_ops.probe("smem-scalar-loop", inp.x)
    with pytest.raises(ValueError, match="at most"):
        probe_ops.probe("lax-cond-datadep", torch.ones(2048))
    with pytest.raises(ValueError, match="row 5"):
        probe_ops.probe("vmem-dynrow-read", inp.x, inp.tab[:4].contiguous())


def test_p2_plain_matches_jax_interpret():
    mod = _jax_probe("probe_trig")
    x = jnp.linspace(-1.0, 1.0, 8 * 128, dtype=jnp.float32).reshape(8, 128)
    want = pl.pallas_call(
        mod.kernel, out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        interpret=True)(x)
    got = probe_trig.uv_sum(torch.tensor(np.asarray(x)))
    assert _common.max_ulps(got, torch.tensor(np.asarray(want))) <= TRIG_ULPS
    # The port's points are the probe's, up to numpy's linspace rounding.
    np.testing.assert_allclose(probe_trig.points((8, 128), "cpu").numpy(),
                               np.asarray(x), rtol=0, atol=2.0 ** -23)


def _jax_layout(variant):
    """micro_raygen.run's camera table and pixel ids."""
    cam_tbl = np.zeros((8, 4), np.float32)
    cam_tbl[:4] = np.eye(4)[:, :4]
    cam_tbl[4:] = np.linalg.inv(np.diag([1.2, 2.1, -1.0, 1.0]))[:4]
    if variant == "packedpx":
        yy, xx = np.meshgrid(np.arange(8), np.arange(128), indexing="ij")
        pix = (yy * 2048 + xx).astype(np.int32)
    else:
        pix = np.arange(1024, dtype=np.int32).reshape(8, 128)
    return cam_tbl, pix


@pytest.mark.parametrize("variant", mr.VARIANTS)
def test_p3_plain_matches_jax_interpret(variant, monkeypatch):
    iters = 3
    mod = _jax_probe("micro_raygen")
    monkeypatch.setattr(mod, "ITERS", iters)
    cam_tbl, pix = _jax_layout(variant)
    f = pl.pallas_call(
        lambda c, p, o: mod.kernel(c, p, o, variant=variant),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        grid=(8,),
        in_specs=[pl.BlockSpec((8, 4), lambda i: (0, 0),
                               memory_space=pltpu.MemorySpace.SMEM),
                  pl.BlockSpec((8, 128), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((8, 128), lambda i: (0, 0)),
        interpret=True)
    want = np.asarray(f(jnp.asarray(cam_tbl), jnp.asarray(pix))).reshape(-1)

    params = mr.camera_params("cpu")
    tpix = mr.pixels(variant, "a", "cpu")
    assert np.array_equal(tpix.numpy(), pix)
    assert np.array_equal(params[:32].numpy().reshape(8, 4), cam_tbl)

    # The PCG state after each iteration's last draw, from JAX's rng and
    # camera on the kernel's loop (micro_raygen.kernel's raygen and body).
    cam = mod._Cam(jnp.asarray(cam_tbl), jnp.float32(10.0), jnp.float32(0.2))
    jpix = jnp.asarray(pix)
    if variant == "packedpx":
        px, py = jpix & 2047, jpix >> 11
    else:
        px, py = jpix % mr.WIDTH, jpix // mr.WIDTH
    sip = jnp.zeros_like(jpix)
    steps = mr.raygen_steps(params, tpix, iters, variant)
    for it, (st, o, d, fl) in enumerate(steps):
        s = sip % mr.SPP
        jst = jrng.init_rng((sip // mr.SPP).astype(jnp.uint32),
                            s.astype(jnp.uint32), py.astype(jnp.uint32),
                            px.astype(jnp.uint32), mr.WIDTH, mr.HEIGHT,
                            mr.SPP) + jnp.uint32(it)
        jst, *_ = jcamera.get_rays_v3(
            jst, cam, px, py, s % mr.SQRT_SPP, s // mr.SQRT_SPP, mr.WIDTH,
            mr.HEIGHT, mr.SQRT_SPP, use_dof=variant != "nodof")
        jst, _ = jrng.random_float(jst)
        assert np.array_equal(np.asarray(jst).astype(np.int64).reshape(-1),
                              st.numpy())
        sip = (sip + 1) % (mr.SPP * 24)

    got = mr.raygen_sums(params, tpix, iters, variant, programs=8)
    assert got.shape == (8, 1024) and torch.equal(got[0], got[7])
    np.testing.assert_allclose(got[0].numpy(), want, rtol=0,
                               atol=RAYGEN_ATOL)


def test_p3_wrapper_rejects_bad_inputs():
    params = mr.camera_params("cpu")
    pix = mr.pixels("base", "a", "cpu")
    with pytest.raises(ValueError, match="variant"):
        mr.raygen_sums(params, pix, 1, "fast")
    with pytest.raises(ValueError, match="params"):
        mr.raygen_sums(params[:38].contiguous(), pix, 1, "base")
    with pytest.raises(ValueError, match="int32"):
        mr.raygen_sums(params, pix.long(), 1, "base")
    with pytest.raises(ValueError, match="programs"):
        mr.raygen_sums(params, pix, 1, "base", programs=0)


def test_p3_full_width_pixels():
    for variant in mr.VARIANTS:
        pix = mr.pixels(variant, "b", "cpu")
        assert pix.shape == (mr.WIDTH * mr.HEIGHT * mr.SPP,)
        p = np.arange(pix.numel()) % (mr.WIDTH * mr.HEIGHT)
        if variant == "packedpx":
            got = (pix.numpy() & 2047) + (pix.numpy() >> 11) * mr.WIDTH
        else:
            got = pix.numpy()
        assert np.array_equal(got, p)


def test_library_path_covers_every_header(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "raygen.cuh"\n')
    (tmp_path / "raygen.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path("k")
    assert first == _build.library_path("k")
    (tmp_path / "raygen.cuh").write_text("// two\n")
    second = _build.library_path("k")
    (tmp_path / "other.cuh").write_text("// a new header\n")
    third = _build.library_path("k")
    (tmp_path / "k.cu").write_text('#include "raygen.cuh"\n// edited\n')
    fourth = _build.library_path("k")
    assert len({first, second, third, fourth}) == 4
    assert first.parent == _build.BUILD_DIR


def test_k4_and_p3_share_the_raygen_header():
    csrc = REPO / "raytrace_tpu_torch" / "csrc"
    header = (csrc / "raygen.cuh").read_text()
    for name in ("megakernel", "micro_raygen", "probe_ops"):
        assert '#include "raygen.cuh"' in (csrc / f"{name}.cu").read_text()
    for fn in ("void get_ray(", "uint32_t init_rng(", "float random_float("):
        assert fn in header
        assert fn not in (csrc / "megakernel.cu").read_text()
    for name in ("probe_ops", "probe_trig", "micro_raygen"):
        assert _build.nvcc_flags(name)[-1] == "-fmad=false"


def test_probe_mains_run_on_the_cpu(capsys, monkeypatch):
    res = probe_ops.main(["--device", "cpu"])
    assert list(res) == list(probe_ops.PROBES)
    assert all(r["ok"] and "ms" not in r for r in res.values())
    monkeypatch.setattr(probe_trig, "SIZES", {"probe": (8, 128),
                                              "large": (1 << 12,)})
    res = probe_trig.main(["--device", "cpu"])
    assert res["large"]["n"] == 1 << 12 and res["probe"]["differing"] == 0
    assert res["probe"]["ulps_vs_float64"] < 4
    res = mr.main(["--device", "cpu", "--shape", "a"])
    assert set(res) == set(mr.VARIANTS)
    assert all(r["a"]["bitwise"] and r["a"]["iters"] == mr.ITERS
               and "ms" not in r["a"] for r in res.values())
    out = capsys.readouterr().out
    assert out.count("PASS ") == 10 and "FAIL" not in out
    assert out.count("arctan2+arccos OK") == 2


def test_probe_mains_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the mains would run")
    for main in (probe_ops.main, probe_trig.main, mr.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([])
