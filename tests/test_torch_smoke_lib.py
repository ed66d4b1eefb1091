"""What chip_smoke.py and tools/chip_probe.py share
(raytrace_tpu_torch/tools/smoke_lib.py), on the CPU: the least time the
card allows, the parse of nvcc's register report, K1's failure
diagnostics and the PyTorch calls timed beside the P1 probes."""

import pytest
import torch

from raytrace_tpu_torch.tools import smoke_lib
from raytrace_tpu_torch.tools_dev import probe_ops

torch.set_num_threads(1)


def test_least_ms_takes_the_larger_time():
    ms, by = smoke_lib.least_ms(smoke_lib.PEAK_FP32_FLOPS / 1e3, 0.0)
    assert (ms, by) == (pytest.approx(1.0), "operations")
    ms, by = smoke_lib.least_ms(0.0, smoke_lib.PEAK_BYTES / 1e3)
    assert (ms, by) == (pytest.approx(1.0), "bytes")
    # INT32 operations at half the FP32 rate.
    ms, by = smoke_lib.least_ms(0.0, 0.0, smoke_lib.PEAK_INT32_OPS / 1e3)
    assert (ms, by) == (pytest.approx(1.0), "operations")


def test_ptxas_forms_names_each_instantiation():
    log = "".join(
        f"ptxas info    : Compiling entry function "
        f"'_Z10megakernelILb{a}ELb{t}ELb{li}ELb{n}ELb{im}ELb{c}EEvPKf' for "
        f"'sm_90a'\nptxas info    : Function properties\n    0 bytes stack "
        f"frame, {spill} bytes spill stores, {spill} bytes spill loads\n"
        f"ptxas info    : Used {regs} registers, 400 bytes cmem[0]\n"
        for a, t, li, n, im, c, regs, spill in (
            (0, 0, 0, 0, 0, 1, 56, 12), (1, 0, 0, 1, 0, 0, 72, 8),
            (0, 1, 1, 1, 1, 1, 72, 28)))
    assert smoke_lib.ptxas_forms(log) == [
        ("static+clusters", 56, 12), ("anim+noise", 72, 8),
        ("tris+lights+noise+image+clusters", 72, 28)]
    assert smoke_lib.ptxas_kernel(log.split("ptxas info    : Compiling")[1]
                                  ) == (56, 12)
    assert len(smoke_lib.K4_FORMS) == 36
    assert set(smoke_lib.K4_FORMS) == {
        *smoke_lib.FORMS_BEFORE, *smoke_lib.IMAGE_FORMS_BEFORE,
        *smoke_lib.CLUSTER_FORMS_BEFORE}


def test_sweep_diagnostics_finds_whole_blocks():
    id_ref = torch.arange(1024, dtype=torch.int32) % 8
    ids = id_ref.clone()
    ids[256:512] = -1          # a 256-ray block that never wrote its ids
    ids[5] = 99                # an id outside [-1, 8)
    t = torch.ones(1024)
    t[7] = float("nan")
    diag = smoke_lib.sweep_diagnostics(ids, id_ref, t, 8)
    assert diag.startswith("257 rays disagree")
    assert f"ids outside [-1, 8) on {1 / 1024:.6f}" in diag
    assert f"t not finite on {1 / 1024:.6f}" in diag
    assert f"{256 / 257:.6f} are a K1 miss and a plain hit" in diag
    assert "1 whole 256-ray blocks disagree (first [1]), of 2 blocks" in diag


@pytest.mark.parametrize("name", probe_ops.PROBES)
def test_library_calls_compute_the_probes(name):
    x, tab = probe_ops.make_inputs("cpu").args(name)
    call = smoke_lib.library_call(name, x, tab)
    if name in ("onehot-fetch", "vmem-scalar-read", "vmem-dynrow-read"):
        assert torch.equal(call(), probe_ops.probe_reference(name, x, tab))
    else:
        assert call is None


def test_grazing_rays_aim_at_box_edges_from_far_away():
    """Each ray's origin lies 1,000-2,000 units from a point within the
    jitter of an edge of one of the boxes, and its direction is a unit
    vector towards that point."""
    import numpy as np

    boxes = np.array([[0.0, 0.0, 0.0, 1.0, 2.0, 3.0],
                      [-5.0, 4.0, 4.0, -4.0, 4.5, 6.0]], np.float32)
    o, d = smoke_lib.grazing_rays(boxes, 256, 3, "cpu")
    o = torch.stack(tuple(o), 1).double()
    d = torch.stack(tuple(d), 1).double()
    assert torch.allclose(d.norm(dim=1), torch.ones(256, dtype=torch.float64),
                          atol=1e-6)
    dist = o.norm(dim=1)
    assert (dist > 990).all() and (dist < 2010).all()
    # Each ray's line comes within 2e-3 of one of the boxes (sampled every
    # 1e-3 around its closest approach to the box's centre).
    steps = torch.arange(-4.0, 4.0, 1e-3, dtype=torch.float64)
    near = []
    for b in torch.tensor(boxes, dtype=torch.float64):
        s = ((((b[:3] + b[3:]) / 2) - o) * d).sum(1, keepdim=True)
        p = o[:, None] + (s + steps)[..., None] * d[:, None]   # [R, S, 3]
        out = torch.maximum(b[:3] - p, p - b[3:]).clamp(min=0).norm(dim=2)
        near.append(out.amin(1))
    assert (torch.stack(near).amin(0) < 2e-3).all()


def test_k3_tables_take_the_tree():
    from types import SimpleNamespace

    assert smoke_lib.k3_tables(SimpleNamespace(tri_tree="tree",
                                               tri_pages=None)) == "tree"
    assert smoke_lib.k3_tables(SimpleNamespace(tri_pages="pages")) == "pages"
