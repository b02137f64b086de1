"""SceneArrays: the device-resident, differentiable SoA scene representation.

Replaces the reference's pointer-rich flattened triangle/material vectors
(``src/kdtree.cpp:34-108``, ``include/kdtree.hpp:15-33``) with a JAX pytree of
structure-of-arrays tensors.  This pytree IS the differentiable parameter set:
pixel losses backpropagate into vertex positions (``tri_v0/v1/v2``), material
colors (``kd``, ``ke``) and texture texels (``tex_data``).

Design notes:
- All hot lookups are gathers from flat arrays indexed by triangle id —
  XLA-native, fusable, and differentiable — instead of virtual dispatch over
  heap BRDF objects (``src/rayTracer.cpp:159-166``).
- Textures of arbitrary sizes are packed into one flat ``(n_texels, 3)``
  buffer with per-texture (offset, width, height), so a single gather serves
  every texture without padding waste.
- Per-triangle ``normal`` is the *mean of the three vertex normals, not
  re-normalized*, exactly as the reference stores it (``src/kdtree.cpp:58-60``)
  — required for allclose parity (the integrator's cosine terms use it raw).
- Static (non-traced) metadata lives in meta fields: triangle/light counts,
  config, texture table sizes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import jax
import numpy as np
import jax.numpy as jnp

from chiaroscuro_tpu.scene.config import RenderConfig
from chiaroscuro_tpu.scene.obj_loader import Mesh, load_obj, load_texture

BRDF_DIFFUSE = 0
BRDF_EMISSIVE = 1
BRDF_PHONG = 2   # diffuse + Phong specular lobe (extension; see integrator)


@dataclasses.dataclass
class SceneArrays:
    # --- geometry (differentiable) ---
    tri_v0: jax.Array  # (T, 3) f32 triangle corner positions
    tri_v1: jax.Array  # (T, 3)
    tri_v2: jax.Array  # (T, 3)
    normal: jax.Array  # (T, 3) mean-of-vertex-normals, NOT unit (kdtree.cpp:58-60)

    # --- material params (differentiable) ---
    kd: jax.Array      # (T, 3) diffuse albedo
    ke: jax.Array      # (T, 3) emitted radiance
    ks: jax.Array      # (T, 3) specular reflectance (Phong extension)
    shininess: jax.Array  # (T,) Phong exponent Ns
    brdf_type: jax.Array  # (T,) int32: BRDF_DIFFUSE | BRDF_EMISSIVE | BRDF_PHONG

    # --- texturing ---
    uv0: jax.Array     # (T, 2) per-corner texcoords (post-FlipUVs)
    uv1: jax.Array     # (T, 2)
    uv2: jax.Array     # (T, 2)
    tex_id: jax.Array  # (T,) int32 index into texture table, -1 = untextured
    tex_id_ks: jax.Array  # (T,) int32 specular-map index, -1 = none
    # Normal/height maps: the reference loads them (model.cpp:104-111) and
    # keeps them GPU-resident but never samples them — neither integrator
    # nor shaders (SURVEY.md quirk 7).  Parity: decode into the same atlas,
    # addressable per-triangle, unsampled by the integrator.
    tex_id_bump: jax.Array  # (T,) int32 normal-map index, -1 = none
    tex_data: jax.Array    # (n_texels, 3) f32 flat texel buffer (differentiable)
    tex_offset: jax.Array  # (n_tex,) int32 start offset into tex_data
    tex_width: jax.Array   # (n_tex,) int32
    tex_height: jax.Array  # (n_tex,) int32

    # --- area lights (emissive triangles, kdtree.cpp:72-77) ---
    light_ids: jax.Array    # (L,) int32 triangle ids (L >= 1; dummy if no lights)
    light_areas: jax.Array  # (L,) f32 triangle surface areas

    # --- point lights (extension; see below) ---
    # The reference declares LightPoint (scene.hpp:11-16) but its parser has
    # no `L` branch and its integrator never reads lightPoints — yet the
    # shipped legacy .rtc scenes (nanosuit.rtc, view_test.rtc) carry
    # `L x y z r g b intensity` lines and the shipped renders
    # (renders/nanosuit.png, renders/view_test.png) are visibly lit by them.
    # We parse them (scene/config.py) and shade them in the integrator:
    # radiant intensity pl_emit = color/255 * intensity, occlusion-tested,
    # with the codebase's 1/(1+d^2) falloff convention (rayTracer.cpp:106).
    pl_pos: jax.Array       # (P, 3) f32 positions (P may be 0)
    pl_emit: jax.Array      # (P, 3) f32 radiant intensity = color/255 * I

    # --- world bounds (kdtree.cpp:106-107, padded by 1e-4) ---
    world_min: jax.Array  # (3,) f32
    world_max: jax.Array  # (3,) f32

    # --- static metadata (not traced) ---
    n_tris: int = dataclasses.field(metadata=dict(static=True), default=0)
    n_lights: int = dataclasses.field(metadata=dict(static=True), default=0)
    n_point_lights: int = dataclasses.field(metadata=dict(static=True), default=0)
    # True iff any triangle uses BRDF_PHONG (enables the specular code path
    # in the integrator; False keeps exact reference-estimator parity).
    has_specular: bool = dataclasses.field(metadata=dict(static=True), default=False)

    @property
    def has_lights(self) -> bool:
        return self.n_lights > 0


jax.tree_util.register_dataclass(
    SceneArrays,
    data_fields=[
        "tri_v0", "tri_v1", "tri_v2", "normal",
        "kd", "ke", "ks", "shininess", "brdf_type",
        "uv0", "uv1", "uv2", "tex_id", "tex_id_ks", "tex_id_bump",
        "tex_data", "tex_offset", "tex_width", "tex_height",
        "light_ids", "light_areas", "pl_pos", "pl_emit",
        "world_min", "world_max",
    ],
    meta_fields=["n_tris", "n_lights", "n_point_lights", "has_specular"],
)


def triangle_areas(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray) -> np.ndarray:
    """0.5 * |cross(v1-v0, v2-v0)| (reference ``kdtree.cpp:72-77``)."""
    return 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)


def build_scene_arrays(
    meshes: Sequence[Mesh],
    textures: Optional[Dict[str, np.ndarray]] = None,
    device_put: bool = True,
    enable_specular: bool = False,
    point_lights: Sequence = (),
) -> SceneArrays:
    """Flatten meshes into the SoA pytree (reference ``kdtree.cpp:34-108``).

    ``textures`` maps texture path -> (H, W, 3) float32 array; when None,
    each mesh's texture paths are decoded from disk.

    ``enable_specular``: classify non-emissive meshes with max(Ks) > 0 as
    ``BRDF_PHONG`` (diffuse + Phong lobe).  Default False = the reference's
    two-type system (``brdf.hpp:8``) for exact estimator parity.
    """
    if textures is None:
        textures = {}
        for m in meshes:
            for p in (
                m.texture_diffuse,
                m.texture_specular if enable_specular else None,
                m.texture_bump,
            ):
                if p and p not in textures:
                    if p.startswith("proc:"):
                        # synthetic scenes carry procedural texture paths
                        # (scene/synthetic.py) instead of files on disk
                        from chiaroscuro_tpu.scene.synthetic import proc_texture

                        textures[p] = proc_texture(p)
                    else:
                        textures[p] = load_texture(p)

    # Texture table: dedup by path, pack into a flat texel buffer.
    tex_paths: List[str] = []
    tex_index: Dict[str, int] = {}
    for m in meshes:
        for p in (m.texture_diffuse, m.texture_specular, m.texture_bump):
            if p and p in textures and p not in tex_index:
                tex_index[p] = len(tex_paths)
                tex_paths.append(p)

    offsets, widths, heights, blobs = [], [], [], []
    cursor = 0
    for p in tex_paths:
        img = np.asarray(textures[p], dtype=np.float32)
        h, w = img.shape[:2]
        offsets.append(cursor)
        widths.append(w)
        heights.append(h)
        blobs.append(img.reshape(-1, 3))
        cursor += h * w
    if not blobs:  # keep shapes non-empty for jit friendliness
        offsets, widths, heights = [0], [1], [1]
        blobs = [np.zeros((1, 3), np.float32)]

    v0s, v1s, v2s, nrms, kds, kes, types = [], [], [], [], [], [], []
    kss, nss = [], []
    uv0s, uv1s, uv2s, tids, tids_ks, tids_bump = [], [], [], [], [], []
    light_ids, light_areas = [], []
    tri_base = 0
    for m in meshes:
        idx = m.indices
        p = m.positions
        n = m.normals
        uv = m.uvs
        i0, i1, i2 = idx[:, 0], idx[:, 1], idx[:, 2]
        nt = len(idx)
        v0s.append(p[i0]); v1s.append(p[i1]); v2s.append(p[i2])
        nrms.append((n[i0] + n[i1] + n[i2]) / 3.0)
        uv0s.append(uv[i0]); uv1s.append(uv[i1]); uv2s.append(uv[i2])
        kds.append(np.broadcast_to(m.diffuse, (nt, 3)))
        kes.append(np.broadcast_to(m.emissive, (nt, 3)))
        kss.append(np.broadcast_to(m.specular, (nt, 3)))
        nss.append(np.full(nt, max(float(m.shininess), 1.0), np.float32))
        is_light = m.is_light
        if is_light:
            btype = BRDF_EMISSIVE
        elif enable_specular and float(np.max(m.specular)) > 0.0:
            btype = BRDF_PHONG
        else:
            btype = BRDF_DIFFUSE
        types.append(np.full(nt, btype, np.int32))
        tid = tex_index.get(m.texture_diffuse, -1) if m.texture_diffuse else -1
        tids.append(np.full(nt, tid, np.int32))
        tid_ks = (
            tex_index.get(m.texture_specular, -1) if m.texture_specular else -1
        )
        tids_ks.append(np.full(nt, tid_ks if enable_specular else -1, np.int32))
        tid_bump = (
            tex_index.get(m.texture_bump, -1) if m.texture_bump else -1
        )
        tids_bump.append(np.full(nt, tid_bump, np.int32))
        if is_light:
            areas = triangle_areas(p[i0], p[i1], p[i2])
            light_ids.extend(range(tri_base, tri_base + nt))
            light_areas.extend(areas.tolist())
        tri_base += nt

    tri_v0 = np.concatenate(v0s).astype(np.float32)
    tri_v1 = np.concatenate(v1s).astype(np.float32)
    tri_v2 = np.concatenate(v2s).astype(np.float32)
    n_tris = len(tri_v0)
    n_lights = len(light_ids)
    if n_lights == 0:
        light_ids, light_areas = [0], [0.0]

    all_pts = np.concatenate([tri_v0, tri_v1, tri_v2])
    world_min = all_pts.min(axis=0) - 1.0e-4  # kdtree.cpp:106-107
    world_max = all_pts.max(axis=0) + 1.0e-4

    n_pl = len(point_lights)
    pl_pos = np.zeros((n_pl, 3), np.float32)
    pl_emit = np.zeros((n_pl, 3), np.float32)
    for i, lp in enumerate(point_lights):
        pl_pos[i] = np.asarray(lp.position, np.float32)
        pl_emit[i] = (
            np.asarray(lp.color, np.float32) / 255.0 * float(lp.intensity)
        )

    put = jnp.asarray if device_put else np.asarray
    return SceneArrays(
        tri_v0=put(tri_v0),
        tri_v1=put(tri_v1),
        tri_v2=put(tri_v2),
        normal=put(np.concatenate(nrms).astype(np.float32)),
        kd=put(np.concatenate(kds).astype(np.float32)),
        ke=put(np.concatenate(kes).astype(np.float32)),
        ks=put(np.concatenate(kss).astype(np.float32)),
        shininess=put(np.concatenate(nss).astype(np.float32)),
        brdf_type=put(np.concatenate(types)),
        uv0=put(np.concatenate(uv0s).astype(np.float32)),
        uv1=put(np.concatenate(uv1s).astype(np.float32)),
        uv2=put(np.concatenate(uv2s).astype(np.float32)),
        tex_id=put(np.concatenate(tids)),
        tex_id_ks=put(np.concatenate(tids_ks)),
        tex_id_bump=put(np.concatenate(tids_bump)),
        tex_data=put(np.concatenate(blobs).astype(np.float32)),
        tex_offset=put(np.asarray(offsets, np.int32)),
        tex_width=put(np.asarray(widths, np.int32)),
        tex_height=put(np.asarray(heights, np.int32)),
        light_ids=put(np.asarray(light_ids, np.int32)),
        light_areas=put(np.asarray(light_areas, np.float32)),
        pl_pos=put(pl_pos),
        pl_emit=put(pl_emit),
        world_min=put(world_min.astype(np.float32)),
        world_max=put(world_max.astype(np.float32)),
        n_tris=n_tris,
        n_lights=n_lights,
        n_point_lights=n_pl,
        has_specular=bool(
            enable_specular
            and any(int(t[0]) == BRDF_PHONG for t in types if len(t))
        ),
    )


def load_scene(cfg: RenderConfig, **obj_kwargs) -> SceneArrays:
    """Config -> meshes -> SceneArrays (reference Scene+Model+KDTree flatten).

    ``input`` paths of the form ``builtin:<name>`` resolve to the programmatic
    scenes in :mod:`chiaroscuro_tpu.scene.builtin` (e.g. ``builtin:cornell_box``,
    ``builtin:cornell_box_original``) — needed because the reference's own
    ``cornell.rtc`` points at an OBJ that was never shipped (SURVEY.md C15).
    """
    if cfg.obj_path.startswith("builtin:"):
        from chiaroscuro_tpu.scene import builtin

        name = cfg.obj_path.split(":", 1)[1]
        meshes = getattr(builtin, name)()
    elif cfg.obj_path.startswith("synthetic:"):
        # e.g. "synthetic:atrium" or "synthetic:atrium:480000" (tri target)
        from chiaroscuro_tpu.scene import synthetic

        parts = cfg.obj_path.split(":")
        generators = {"atrium": synthetic.atrium}
        if parts[1] not in generators:
            raise ValueError(
                f"unknown synthetic generator {parts[1]!r}; "
                f"available: {sorted(generators)}"
            )
        gen = generators[parts[1]]
        meshes = gen(int(parts[2])) if len(parts) > 2 else gen()
    else:
        meshes = load_obj(cfg.obj_path, **obj_kwargs)
    scene = build_scene_arrays(
        meshes,
        enable_specular=cfg.enable_specular,
        point_lights=cfg.light_points if cfg.use_point_lights else (),
    )
    _log_scene(scene)
    return scene


def _log_scene(scene: SceneArrays) -> None:
    # Parity with the reference's scene statistics banner (kdtree.cpp:91-104).
    print(f"Triangles in scene: {scene.n_tris}")
    print(
        "Surface Lights in scene:"
        + (f" {scene.n_lights}" if scene.n_lights else " None.")
    )
