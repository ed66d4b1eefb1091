"""Scene compiler: SceneFile → CompiledScene (frozen SoA arrays).

This is the TPU-native replacement for the reference's host-side GPU-resource
construction (raytracer/src/render_engine.rs:109-394): meshes, materials,
texture registries, the light alias table and instance transforms all become
padded numpy arrays with explicit counts — the analogue of the reference's
"1-element dummy buffer + count push constant" pattern (material.rs:122-125).

Key differences from the reference, by design:

- Triangles are flattened per *instance* into one global soup with
  precomputed per-triangle material/instance ids, eliminating the reference's
  O(meshId) prefix-sum loop per hit (ray_gen.glsl:124-128).
- Object-space geometry + decomposed per-instance transforms are kept so the
  device re-transforms the soup per sample batch (motion blur) instead of
  refitting a TLAS (acceleration.rs:91-115).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..scene_file import (
    CheckerTexture,
    ConstantTexture,
    Dielectric,
    DiffuseLight,
    ImageTexture,
    Lambertian,
    Metal,
    NoiseTexture,
    SceneError,
    SceneFile,
    SolidSky,
    VerticalGradientSky,
)
from ..utils.profiling import span
from .alias_table import build_alias_table
from .tessellate import Mesh, mesh_from_primitive
from .transform import DecomposedTransform, decompose_matrix

log = logging.getLogger(__name__)

# Material type tags (common.glsl:15-19).
MAT_TYPE_NONE = 0
MAT_TYPE_LAMBERTIAN = 1
MAT_TYPE_METAL = 2
MAT_TYPE_DIELECTRIC = 3
MAT_TYPE_DIFFUSE_LIGHT = 4

# Material property (texture) value tags (common.glsl:21-24).
MAT_PROP_RGB = 0
MAT_PROP_IMAGE = 1
MAT_PROP_CHECKER = 2
MAT_PROP_NOISE = 3

# Sky type tags (common.glsl:61-63).
SKY_NONE = 0
SKY_SOLID = 1
SKY_VERTICAL_GRADIENT = 2

TRI_PAD = 256  # triangle soup padded to a multiple of this


@dataclass(frozen=True)
class RenderConfig:
    """Static render settings — hashable, used as a jit static argument."""

    width: int
    height: int
    samples_per_pixel: int
    sample_batches: int
    max_ray_depth: int
    aspect_ratio: float
    camera: str

    @property
    def sqrt_spp(self) -> int:
        # The reference loops sqrt(spp) x sqrt(spp); non-square spp truncates
        # (quirk: ray_gen.glsl:584-586).
        return int(np.sqrt(self.samples_per_pixel))

    @property
    def effective_spp(self) -> int:
        return self.sqrt_spp * self.sqrt_spp


@dataclass
class CameraParams:
    eye: np.ndarray
    look_at: np.ndarray
    up: np.ndarray
    fov_y_deg: float
    z_near: float
    z_far: float
    focal_length: float
    aperture_size: float


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    """Pad axis 0 to length n with zeros."""
    if a.shape[0] == n:
        return a
    pad = [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad)


@dataclass
class CompiledScene:
    """Everything the device kernels need, as numpy SoA arrays.

    Counts are carried separately from (padded) array lengths.  All float
    arrays are float32, ids are int32.
    """

    # --- triangle soup (object space, instance-flattened) ---
    tri_p: np.ndarray         # [T, 3, 3]
    tri_n: np.ndarray         # [T, 3, 3]
    tri_uv: np.ndarray        # [T, 3, 2]
    tri_inst: np.ndarray      # [T] instance id
    tri_mat_type: np.ndarray  # [T]
    tri_mat_index: np.ndarray # [T]
    num_triangles: int        # actual (unpadded) count

    # --- analytic spheres (instance-flattened; empty in mesh mode) ---
    # TPU-native fast path: uv_sphere primitives are intersected in closed
    # form as dense vector math instead of 2M-triangle BVH pointer chasing.
    # The reference tessellates only because the Vulkan RT pipeline demands
    # triangles (mesh.rs:155-258); "Ray Tracing in One Weekend" spheres are
    # analytic to begin with.  Mesh mode (analytic_spheres=False) reproduces
    # the reference's tessellated geometry exactly.
    sph_center: np.ndarray    # [S, 3] object space
    sph_radius: np.ndarray    # [S]
    sph_inst: np.ndarray      # [S] instance id
    sph_mat_type: np.ndarray  # [S]
    sph_mat_index: np.ndarray # [S]
    num_spheres: int

    # --- instances ---
    inst_t0: np.ndarray       # [I, 10] translation(3) quat(4) scale(3), t=0
    inst_t1: np.ndarray       # [I, 10] t=1 (equal to t0 when static)
    inst_animated: np.ndarray # [I] bool
    num_instances: int
    any_animated: bool

    # --- light sampling (object-space light triangles + alias table) ---
    light_prob: np.ndarray    # [L]
    light_alias: np.ndarray   # [L]
    light_tri_p: np.ndarray   # [L, 3, 3] object-space positions
    light_count: int
    light_total_area: float

    # --- textures ---
    const_colours: np.ndarray   # [C, 3]
    checker_scale: np.ndarray   # [K]
    checker_even: np.ndarray    # [K, 2] (ptype, pindex)
    checker_odd: np.ndarray     # [K, 2]
    noise_scale: np.ndarray     # [N]
    atlas: np.ndarray           # [NI, AH, AW, 3] uint8 sRGB texels
    atlas_wh: np.ndarray        # [NI, 2] (width, height)

    # --- materials ---
    lamb_albedo: np.ndarray     # [NL, 2] (ptype, pindex)
    metal_albedo: np.ndarray    # [NM, 2]
    metal_fuzz: np.ndarray      # [NM, 2]
    diel_ri: np.ndarray         # [ND]
    light_emit: np.ndarray      # [NDL, 2]

    # --- sky ---
    sky_type: int
    sky_solid: np.ndarray       # [3]
    sky_top: np.ndarray         # [3]
    sky_bottom: np.ndarray      # [3]
    sky_factor: float

    # --- cameras & render defaults ---
    cameras: Dict[str, CameraParams]
    render: RenderConfig

    # --- bookkeeping for tests / tooling ---
    mesh_names: List[str] = field(default_factory=list)
    # Per-instance soup offsets.  INVALIDATED (set to None) once triangle
    # clustering permutes the soup (sphere_order.apply_triangle_order):
    # the offsets would no longer delimit contiguous per-mesh runs.
    mesh_tri_offsets: Optional[np.ndarray] = None

    # --- pre-resolved per-primitive shading rows (models/shading_table.py)
    # Row i: sphere i; row S_pad + j: triangle j.  None when the material
    # graph doesn't fit the fat-row encoding (fallback to registry path).
    shade_rows: Optional[np.ndarray] = None  # [S_pad + T_pad, 32]

    # --- sphere-block layout (models/sphere_order.py) ---
    # First sph_prefix spheres are "global" (swept densely); the rest are
    # Morton-ordered so consecutive 8/16-sphere clusters are spatially tight
    # for the megakernel's selective sweep.  0 = unordered.
    sph_prefix: int = 0

    # --- triangle-block layout (models/sphere_order.py) ---
    # Triangles grouped into greedy spatial clusters of this size for the
    # megakernel's tri-gather sweep.  0 = file order (dense sweep).
    tri_cluster_g: int = 0


def _resolve_texture_registries(scene: SceneFile):
    """Build texture registries in scene-file order and a name resolver.

    The reference iterates a HashMap (nondeterministic order); we use stable
    file order — indices are internal, behaviour is identical.
    """
    const_names, const_colours = [], []
    image_names, image_paths = [], []
    checker_list = []  # (name, scale, even_name, odd_name)
    noise_names, noise_scales = [], []

    seen = set()
    for tex in scene.textures:
        if tex.name in seen:
            continue  # duplicate names keep the first occurrence (lib.rs:82-95)
        seen.add(tex.name)
        if isinstance(tex, ConstantTexture):
            const_names.append(tex.name)
            const_colours.append(tex.rgb)
        elif isinstance(tex, ImageTexture):
            image_names.append(tex.name)
            image_paths.append(tex.path)
        elif isinstance(tex, CheckerTexture):
            checker_list.append((tex.name, tex.scale, tex.even, tex.odd))
        elif isinstance(tex, NoiseTexture):
            noise_names.append(tex.name)
            noise_scales.append(tex.scale)

    const_idx = {n: i for i, n in enumerate(const_names)}
    image_idx = {n: i for i, n in enumerate(image_names)}
    checker_idx = {name: i for i, (name, *_rest) in enumerate(checker_list)}
    noise_idx = {n: i for i, n in enumerate(noise_names)}

    def resolve(name: str) -> Tuple[int, int]:
        if name in const_idx:
            return (MAT_PROP_RGB, const_idx[name])
        if name in image_idx:
            return (MAT_PROP_IMAGE, image_idx[name])
        if name in checker_idx:
            return (MAT_PROP_CHECKER, checker_idx[name])
        if name in noise_idx:
            return (MAT_PROP_NOISE, noise_idx[name])
        raise SceneError(f"Texture '{name}' not found")

    checker_scale = np.asarray([c[1] for c in checker_list], np.float32)
    checker_even = np.asarray(
        [resolve(c[2]) for c in checker_list], np.int32
    ).reshape(-1, 2)
    checker_odd = np.asarray(
        [resolve(c[3]) for c in checker_list], np.int32
    ).reshape(-1, 2)

    return {
        "const_colours": np.asarray(const_colours, np.float32).reshape(-1, 3),
        "image_paths": image_paths,
        "checker_scale": checker_scale,
        "checker_even": checker_even,
        "checker_odd": checker_odd,
        "noise_scale": np.asarray(noise_scales, np.float32),
        "resolve": resolve,
    }


def _load_image_atlas(paths: List[str]):
    """Decode image textures to a padded uint8 sRGB atlas.

    The reference uploads R8G8B8A8_SRGB and samples with a default (nearest,
    repeat) sampler (render_engine.rs:241-247); the device kernel replicates
    nearest/repeat + per-texel sRGB decode.
    """
    if not paths:
        return np.zeros((1, 1, 1, 3), np.uint8), np.ones((1, 2), np.int32)

    from PIL import Image

    imgs = []
    for p in paths:
        with Image.open(p) as im:
            imgs.append(np.asarray(im.convert("RGB"), dtype=np.uint8))
    max_h = max(im.shape[0] for im in imgs)
    max_w = max(im.shape[1] for im in imgs)
    atlas = np.zeros((len(imgs), max_h, max_w, 3), np.uint8)
    wh = np.zeros((len(imgs), 2), np.int32)
    for i, im in enumerate(imgs):
        atlas[i, : im.shape[0], : im.shape[1]] = im
        wh[i] = (im.shape[1], im.shape[0])
    return atlas, wh


def _compile_materials(scene: SceneFile, resolve):
    lamb_albedo, metal_albedo, metal_fuzz, diel_ri, light_emit = [], [], [], [], []
    name_to_mat: Dict[str, Tuple[int, int]] = {}

    for mat in scene.materials:
        if isinstance(mat, Lambertian):
            name_to_mat[mat.name] = (MAT_TYPE_LAMBERTIAN, len(lamb_albedo))
            lamb_albedo.append(resolve(mat.albedo))
        elif isinstance(mat, Metal):
            name_to_mat[mat.name] = (MAT_TYPE_METAL, len(metal_albedo))
            metal_albedo.append(resolve(mat.albedo))
            metal_fuzz.append(resolve(mat.fuzz))
        elif isinstance(mat, Dielectric):
            name_to_mat[mat.name] = (MAT_TYPE_DIELECTRIC, len(diel_ri))
            diel_ri.append(mat.refraction_index)
        elif isinstance(mat, DiffuseLight):
            name_to_mat[mat.name] = (MAT_TYPE_DIFFUSE_LIGHT, len(light_emit))
            light_emit.append(resolve(mat.emit))

    as_i32 = lambda lst: np.asarray(lst, np.int32).reshape(-1, 2)
    return {
        "lamb_albedo": as_i32(lamb_albedo),
        "metal_albedo": as_i32(metal_albedo),
        "metal_fuzz": as_i32(metal_fuzz),
        "diel_ri": np.asarray(diel_ri, np.float32),
        "light_emit": as_i32(light_emit),
        "name_to_mat": name_to_mat,
    }


def _decompose_instance(inst) -> Tuple[DecomposedTransform, DecomposedTransform, bool]:
    start_m, end_m = inst.object_to_world_matrices()
    t0 = decompose_matrix(start_m)
    if end_m is None:
        return t0, t0, False
    return t0, decompose_matrix(end_m), True


def _pack_trs(t: DecomposedTransform) -> np.ndarray:
    return np.concatenate([t.translation, t.rotation, t.scale]).astype(np.float32)


def _build_light_table(scene_meshes, instances, name_to_mat):
    """Alias table over world-space light-triangle areas (light.rs:30-134).

    Light triangles are stored in OBJECT space: the reference shader
    transforms the sampled triangle by the *hit instance's* objectToWorld
    (quirk #2, ray_gen.glsl:252-281 & :516), which we replicate in the
    sampling kernel.
    """
    areas, tri_ps = [], []
    for mesh_index, trs0, trs1, animated in instances:
        mesh: Mesh = scene_meshes[mesh_index]
        mat = name_to_mat.get(mesh.material, (MAT_TYPE_NONE, 0))
        if mat[0] != MAT_TYPE_DIFFUSE_LIGHT:
            continue
        if animated:
            raise SceneError("Animated transform for light sources not implemented")
        m = trs0.to_matrix()
        tp, _, _ = mesh.triangles()  # [T,3,3] object space
        world = tp @ m[:3, :3].T + m[:3, 3]
        v0 = world[:, 1] - world[:, 0]
        v1 = world[:, 2] - world[:, 0]
        a = 0.5 * np.linalg.norm(np.cross(v0, v1), axis=-1)
        keep = a > 1e-8  # degenerate-area cutoff (light.rs:81-88)
        areas.append(a[keep].astype(np.float32))
        tri_ps.append(tp[keep].astype(np.float32))

    if not areas or sum(len(a) for a in areas) == 0:
        return (
            np.zeros(1, np.float32),
            np.zeros(1, np.int32),
            np.zeros((1, 3, 3), np.float32),
            0,
            0.0,
        )

    areas = np.concatenate(areas)
    tri_ps = np.concatenate(tri_ps)
    prob, alias, total = build_alias_table(areas)
    return prob, alias, tri_ps, len(areas), total


def compile_scene(scene: SceneFile, width: Optional[int] = None,
                  height: Optional[int] = None,
                  analytic_spheres: bool = True) -> CompiledScene:
    """Compile a SceneFile to device-ready SoA arrays.

    width/height default to the reference's 1024-logical-width window scaled
    by the scene aspect ratio (bin/src/app.rs:34, 141-148).

    analytic_spheres=True (default) compiles uv_sphere instances into the
    closed-form sphere table instead of the triangle soup; the light alias
    table always uses tessellated geometry (light.rs semantics).
    """
    with span("scene.compile"):
        return _compile_scene(scene, width, height, analytic_spheres)


def _compile_scene(scene: SceneFile, width: Optional[int],
                   height: Optional[int],
                   analytic_spheres: bool) -> CompiledScene:
    scene.validate()

    ar = scene.render.aspect_ratio
    if width is None and height is None:
        width, height = 1024, max(1, round(1024 / ar))
    elif height is None:
        height = max(1, round(width / ar))
    elif width is None:
        width = max(1, round(height * ar))

    tex = _resolve_texture_registries(scene)
    mats = _compile_materials(scene, tex["resolve"])
    name_to_mat = mats["name_to_mat"]

    # Tessellate meshes in primitive order (render_engine.rs:130-137).
    meshes: List[Mesh] = []
    mesh_name_to_index: Dict[str, int] = {}
    for prim in scene.primitives:
        mesh_name_to_index[prim.name] = len(meshes)
        meshes.append(mesh_from_primitive(prim))

    # Instances (render_engine.rs:140-149).
    instances = []
    for inst in scene.instances:
        if inst.name not in mesh_name_to_index:
            raise SceneError(f"Mesh {inst.name} not found")
        t0, t1, animated = _decompose_instance(inst)
        instances.append((mesh_name_to_index[inst.name], t0, t1, animated))

    if not instances:
        raise SceneError("Scene has no instances")

    # Light table.
    light_prob, light_alias, light_tri_p, light_count, light_area = _build_light_table(
        meshes, instances, name_to_mat
    )

    # Which primitives take the analytic-sphere path.
    from ..scene_file import UvSphere

    sphere_prim = {
        prim.name: prim for prim in scene.primitives if isinstance(prim, UvSphere)
    } if analytic_spheres else {}

    # Triangle soup: instance-major flattening with per-triangle material ids.
    tri_p_parts, tri_n_parts, tri_uv_parts = [], [], []
    tri_inst_parts, tri_mt_parts, tri_mi_parts = [], [], []
    sph_center, sph_radius, sph_inst, sph_mt, sph_mi = [], [], [], [], []
    soup_offsets = [0]
    for i, (mesh_index, _t0, _t1, _anim) in enumerate(instances):
        mesh = meshes[mesh_index]
        mt, mi = name_to_mat.get(mesh.material, (MAT_TYPE_NONE, 0))
        if (mt, mi) == (MAT_TYPE_NONE, 0) and mesh.material not in name_to_mat:
            log.info("Mesh '%s' material '%s' not found", mesh.name, mesh.material)
        if mesh.name in sphere_prim:
            prim = sphere_prim[mesh.name]
            sph_center.append(np.asarray(prim.center, np.float32))
            sph_radius.append(np.float32(prim.radius))
            sph_inst.append(i)
            sph_mt.append(mt)
            sph_mi.append(mi)
            continue
        tp, tn, tuv = mesh.triangles()
        t_count = tp.shape[0]
        tri_p_parts.append(tp)
        tri_n_parts.append(tn)
        tri_uv_parts.append(tuv)
        tri_inst_parts.append(np.full(t_count, i, np.int32))
        tri_mt_parts.append(np.full(t_count, mt, np.int32))
        tri_mi_parts.append(np.full(t_count, mi, np.int32))
        soup_offsets.append(soup_offsets[-1] + t_count)

    if tri_p_parts:
        tri_p = np.concatenate(tri_p_parts).astype(np.float32)
        tri_n = np.concatenate(tri_n_parts).astype(np.float32)
        tri_uv = np.concatenate(tri_uv_parts).astype(np.float32)
        tri_inst = np.concatenate(tri_inst_parts)
        tri_mt = np.concatenate(tri_mt_parts)
        tri_mi = np.concatenate(tri_mi_parts)
    else:
        tri_p = np.zeros((0, 3, 3), np.float32)
        tri_n = np.zeros((0, 3, 3), np.float32)
        tri_uv = np.zeros((0, 3, 2), np.float32)
        tri_inst = np.zeros(0, np.int32)
        tri_mt = np.zeros(0, np.int32)
        tri_mi = np.zeros(0, np.int32)

    num_spheres = len(sph_radius)
    # Pad to a multiple of 8: the sweep runs spheres on the sublane axis
    # ([C, R] layout), so 8 is a full tile and tiny scenes waste nothing.
    SPH_PAD = 8
    s_padded = max(SPH_PAD, -(-max(num_spheres, 1) // SPH_PAD) * SPH_PAD)
    sph_center_a = np.zeros((s_padded, 3), np.float32)
    sph_radius_a = np.zeros(s_padded, np.float32)  # r=0 padding never hits
    sph_inst_a = np.zeros(s_padded, np.int32)
    sph_mt_a = np.zeros(s_padded, np.int32)
    sph_mi_a = np.zeros(s_padded, np.int32)
    if num_spheres:
        sph_center_a[:num_spheres] = np.stack(sph_center)
        sph_radius_a[:num_spheres] = sph_radius
        sph_inst_a[:num_spheres] = sph_inst
        sph_mt_a[:num_spheres] = sph_mt
        sph_mi_a[:num_spheres] = sph_mi

    num_tris = tri_p.shape[0]
    padded = max(TRI_PAD, -(-max(num_tris, 1) // TRI_PAD) * TRI_PAD)
    tri_p = _pad_rows(tri_p, padded)
    tri_n = _pad_rows(tri_n, padded)
    tri_uv = _pad_rows(tri_uv, padded)
    tri_inst = _pad_rows(tri_inst, padded)
    tri_mt = _pad_rows(tri_mt, padded)
    tri_mi = _pad_rows(tri_mi, padded)

    inst_t0 = np.stack([_pack_trs(t0) for _, t0, _, _ in instances])
    inst_t1 = np.stack([_pack_trs(t1) for _, _, t1, _ in instances])
    inst_animated = np.asarray([a for *_x, a in instances], bool)

    atlas, atlas_wh = _load_image_atlas(tex["image_paths"])

    # Sky (scene_file/src/sky.rs:22-44).
    sky = scene.sky
    if isinstance(sky, SolidSky):
        sky_type, solid = SKY_SOLID, np.asarray(sky.rgb, np.float32)
        top, bottom, factor = solid, solid, 0.0
    elif isinstance(sky, VerticalGradientSky):
        sky_type = SKY_VERTICAL_GRADIENT
        solid = np.asarray(sky.top, np.float32)
        top = np.asarray(sky.top, np.float32)
        bottom = np.asarray(sky.bottom, np.float32)
        factor = float(sky.factor)
    else:
        sky_type = SKY_NONE
        solid = top = bottom = np.zeros(3, np.float32)
        factor = 0.0

    cameras = {
        c.name: CameraParams(
            eye=np.asarray(c.eye, np.float32),
            look_at=np.asarray(c.look_at, np.float32),
            up=np.asarray(c.up, np.float32),
            fov_y_deg=float(c.fov_y),
            z_near=float(c.z_near),
            z_far=float(c.z_far),
            focal_length=float(c.focal_length),
            aperture_size=float(c.aperture_size),
        )
        for c in scene.cameras
    }

    render = RenderConfig(
        width=int(width),
        height=int(height),
        samples_per_pixel=scene.render.samples_per_pixel,
        sample_batches=scene.render.sample_batches,
        max_ray_depth=scene.render.max_ray_depth,
        aspect_ratio=float(ar),
        camera=scene.render.camera,
    )

    # Pre-resolve per-primitive shading rows (single-fetch shading).
    from .shading_table import ComplexMaterial, build_shading_rows

    try:
        all_mt = np.concatenate([sph_mt_a, tri_mt])
        all_mi = np.concatenate([sph_mi_a, tri_mi])
        shade_rows = build_shading_rows(all_mt, all_mi, mats, tex)
    except ComplexMaterial as e:
        log.info("material graph exceeds fat-row encoding (%s); "
                 "shading falls back to registry lookups", e)
        shade_rows = None

    def min1(a, shape_tail=()):
        """Tables need at least one (dummy) row so shapes stay static."""
        if a.shape[0] > 0:
            return a
        return np.zeros((1,) + tuple(shape_tail), a.dtype)

    cs = CompiledScene(
        tri_p=tri_p, tri_n=tri_n, tri_uv=tri_uv,
        tri_inst=tri_inst, tri_mat_type=tri_mt, tri_mat_index=tri_mi,
        num_triangles=num_tris,
        sph_center=sph_center_a, sph_radius=sph_radius_a, sph_inst=sph_inst_a,
        sph_mat_type=sph_mt_a, sph_mat_index=sph_mi_a, num_spheres=num_spheres,
        inst_t0=inst_t0, inst_t1=inst_t1, inst_animated=inst_animated,
        num_instances=len(instances),
        any_animated=bool(inst_animated.any()),
        light_prob=light_prob, light_alias=light_alias, light_tri_p=light_tri_p,
        light_count=light_count, light_total_area=light_area,
        const_colours=min1(tex["const_colours"], (3,)),
        checker_scale=min1(tex["checker_scale"]),
        checker_even=min1(tex["checker_even"], (2,)),
        checker_odd=min1(tex["checker_odd"], (2,)),
        noise_scale=min1(tex["noise_scale"]),
        atlas=atlas, atlas_wh=atlas_wh,
        lamb_albedo=min1(mats["lamb_albedo"], (2,)),
        metal_albedo=min1(mats["metal_albedo"], (2,)),
        metal_fuzz=min1(mats["metal_fuzz"], (2,)),
        diel_ri=min1(mats["diel_ri"]),
        light_emit=min1(mats["light_emit"], (2,)),
        sky_type=sky_type, sky_solid=solid, sky_top=top, sky_bottom=bottom,
        sky_factor=factor,
        cameras=cameras,
        render=render,
        mesh_names=[m.name for m in meshes],
        mesh_tri_offsets=np.asarray(soup_offsets, np.int64),
        shade_rows=shade_rows,
    )

    # Spatial sphere ordering for the megakernel's selective sweep
    # (image-invariant: sphere ids are internal).
    from .sphere_order import apply_sphere_order, apply_triangle_order

    apply_sphere_order(cs)
    apply_triangle_order(cs)
    return cs
