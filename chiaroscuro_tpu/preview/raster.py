"""Walk-through "raster" frame — analog of the reference's TAB raster mode.

The reference's preview rasterizes the scene with OpenGL while flying the
camera (``src/openglPreview.cpp:67-89``): textured meshes draw their diffuse
texture directly (``shader/simple_fs.glsl``), untextured meshes draw Phong
ambient/diffuse/specular from **one** light — the first point light, or a
white light at the scene's VP when there are none (``openglPreview.cpp:82-86``,
``shader/material.fs:24-43``).

A headless accelerator host has no GL stack, so the walk-through frame is
produced by the same
machinery as the path tracer: one primary-visibility closest-hit wavefront
(no bounces, no NEE, no RNG), shaded per the shaders above.  This is *much*
faster than a path-traced layer — the point of the raster mode — and runs on
the device.

Divergence (documented): ``material.fs`` reads the material's *ambient* color;
``SceneArrays`` deliberately has no Ka field (the loader's Ka→Ke promotion
rule, ``scene/obj_loader.py``), so ambient ≈ 0.1 * Kd here.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from chiaroscuro_tpu.geometry import planar as P
from chiaroscuro_tpu.geometry.camera import camera_basis, primary_ray_dirs_planar
from chiaroscuro_tpu.render.integrator import _atlas_fetch_planar
from chiaroscuro_tpu.scene.scene_arrays import SceneArrays

AMBIENT = 0.1


@partial(jax.jit, static_argnames=("xres", "yres", "closest_fn"))
def _raster_frame_jit(
    scene: SceneArrays, eye, center, up, yview, xres: int, yres: int,
    light_pos, light_color, closest_fn,
):
    left_upper, dx, dy = camera_basis(eye, center, up, yview, xres, yres)
    ys, xs = jnp.meshgrid(
        jnp.arange(yres, dtype=jnp.float32),
        jnp.arange(xres, dtype=jnp.float32),
        indexing="ij",
    )
    R = xres * yres
    pad = (-R) % 128
    pxf = jnp.concatenate([xs.reshape(-1), jnp.zeros(pad, jnp.float32)])
    pyf = jnp.concatenate([ys.reshape(-1), jnp.zeros(pad, jnp.float32)])
    B = ((R + pad) // 128, 128)
    pxf, pyf = pxf.reshape(B), pyf.reshape(B)
    half = jnp.float32(0.5)  # pixel centers (no AA jitter in raster mode)
    dirs = primary_ray_dirs_planar(left_upper, dx, dy, pxf, pyf, half, half)
    origins = jnp.broadcast_to(eye[:, None, None], (3,) + B)

    closest_planar = getattr(closest_fn, "planar_fn", None)
    if closest_planar is not None:
        res = closest_planar(origins, dirs)
        hit, bu, bv = res.hit, res.u, res.v
        A = res.attrs
        point = A["v0"] + P.pscale(bu, A["e1"]) + P.pscale(bv, A["e2"])
        normal, kd, ks, ns = A["normal"], A["kd"], A["ks"], A["ns"]
        texid = A["texid"]
        uvp = (
            A["uv0"] * (1.0 - bu - bv)[None]
            + A["uv1"] * bu[None]
            + A["uv2"] * bv[None]
        )
    else:
        res = closest_fn(P.to_rows(origins), P.to_rows(dirs))
        hit = res.hit.reshape(B)
        bu, bv = res.u, res.v
        tid = res.tid

        def pv(rows3):
            return P.to_planar(rows3, B)

        point = pv(
            scene.tri_v0[tid] * (1.0 - bu - bv)[:, None]
            + scene.tri_v1[tid] * bu[:, None]
            + scene.tri_v2[tid] * bv[:, None]
        )
        normal = pv(scene.normal[tid])
        kd = pv(scene.kd[tid])
        ks = pv(scene.ks[tid])
        ns = scene.shininess[tid].reshape(B)
        texid = scene.tex_id[tid].reshape(B)
        uv = (
            scene.uv0[tid] * (1.0 - bu - bv)[:, None]
            + scene.uv1[tid] * bu[:, None]
            + scene.uv2[tid] * bv[:, None]
        )
        uvp = jnp.stack([uv[:, 0].reshape(B), uv[:, 1].reshape(B)])

    n = P.pnormalize(normal)
    lp = light_pos[:, None, None]
    lc = light_color[:, None, None]
    ldir = P.pnormalize(lp - point)
    diff = jnp.maximum(0.0, P.pdot(n, ldir))
    vdir = P.pnormalize(origins - point)
    refl = 2.0 * P.pscale(P.pdot(ldir, n), n) - ldir
    spec = jnp.power(jnp.maximum(0.0, P.pdot(vdir, refl)), jnp.maximum(ns, 1.0))
    phong = lc * (AMBIENT * kd + P.pscale(diff, kd) + P.pscale(spec, ks))

    # Textured meshes: raw texture color (simple_fs.glsl); untextured: Phong.
    tex = _atlas_fetch_planar(scene, texid, uvp, kd)
    color = jnp.where((texid >= 0)[None], tex, phong)
    color = P.pwhere(hit, color, 0.0)           # glClearColor black
    return P.to_rows(color)[:R].reshape(yres, xres, 3)


def raster_frame(scene: SceneArrays, cfg, camera, closest_fn) -> np.ndarray:
    """One flat-shaded walk-through frame from a :class:`FlyCamera`.

    Returns (yres, xres, 3) float32 in [0, ~inf) — display via clip, not the
    path tracer's tone map (the GL raster pipeline never tone-mapped either).
    """
    eye, center, up, yview = camera.render_args()
    if cfg.light_points:
        lp = np.asarray(cfg.light_points[0].position, np.float32)
        lc = np.asarray(cfg.light_points[0].color, np.float32)
    else:
        lp = np.asarray(cfg.vp, np.float32)      # openglPreview.cpp:83-86
        lc = np.ones(3, np.float32)
    img = _raster_frame_jit(
        scene,
        jnp.asarray(eye), jnp.asarray(center), jnp.asarray(up),
        jnp.float32(yview), cfg.xres, cfg.yres,
        jnp.asarray(lp), jnp.asarray(lc), closest_fn,
    )
    return np.asarray(img)
