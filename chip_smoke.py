"""Smoke test of the path tracer's main path on an NVIDIA GPU.

    python chip_smoke.py               # one card, every phase below
    python chip_smoke.py --devices 4   # four cards: sharded render + grad

One process drives the card(s); nothing here starts another JAX process.
Phases on one card, in order:

1. device: JAX must see a GPU, or the script exits non-zero with no result;
2. kernels: the cluster-visit kernel compiled at real widths on the
   480k- and 20k-triangle atria (1280x720 primary wavefront + shadow
   rays), compared with the brute-force oracle on a 64k-ray subset and
   with the lock-step BVH on the whole frame;
3. batch render: the CLI on ``scenes/cornell.rtc`` at its own 768x768 and
   k=6 (samples cut, see CORNELL_SPP), image checked finite and lit;
4. large scene: ``Renderer`` with ``auto`` on the 480k atrium, 1280x720,
   1 spp, depth 3;
5. goldens: two ``tools/make_goldens.py`` fixtures rendered on the card
   against the committed CPU renders, and the cornell scene at its own
   camera against a CPU render in this process (see GOLDEN_BOUNDS);
6. inverse rendering: three Adam steps on cornell ``kd``/``ke``;
7. GPU tests: ``pytest -m gpu``.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``.  Every earlier
result line carries the card's name and power limit.  A failed phase
raises and the script exits non-zero.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "smoke")

# Kernel vs oracle/BVH agreement.  Both sides compute Moller-Trumbore in
# float32 but compile it differently (Triton vs XLA: FMA contraction and
# division rounding differ), so a ray that grazes a triangle edge can hit
# on one side and miss on the other, and its t differs in the last bits.
T_RTOL = 1e-4          # |dt| <= T_RTOL * t where both hit the same triangle
TIE_RTOL = 1e-5        # ids may differ where the two t lie this close
FLIP_FRAC = 1e-4       # rays allowed to disagree beyond that (edge grazes)

# Sizes: the atria of bench.py's cells and the wavefront of a 720p frame.
KERNEL_ATRIA = (480_000, 20_000)
LARGE_ATRIUM = 480_000
FRAME = (1280, 720)
ORACLE_RAYS = 65536

# Cornell batch render: the file's own 768x768 and k=6; its 1000 samples
# are cut to keep the whole script inside its time budget.
CORNELL_RES = 768
CORNELL_SPP = 64

# GPU renders vs CPU renders, per pixel in the band of
# tests/test_self_golden.py, with a bound for each comparison.  Each
# bound is (min share of pixels in the band, max mean relative error over
# the pixels in the band, max relative shift of their mean).  The two
# backends round Moller-Trumbore, normalisation and sampling differently
# in the last bits, so a path whose hit, shadow or Russian-roulette
# decision is a near-tie may go another way: that pixel then leaves the
# band by a whole path's radiance (up to 1.1 on atrium_160x90, where one
# such pixel moves the whole image's mean by 1.7e-4).  On a view without
# systematic ties that touches a few pixels, and which ones changes with
# the compiled program, so the share bound counts them and the error and
# shift bounds hold every other pixel as tightly as the CPU reproduces
# the golden.  The whole image's error and shift are printed, not bound.
# Readings behind each bound: PERF.md, Findings.
GOLDEN_RTOL, GOLDEN_ATOL = 2e-3, 1e-4
# The golden is stored in half precision, which alone gives a mean
# relative error of about 1.8e-4 and an image-mean shift of up to 5e-6.
GOLDEN_BOUNDS = {
    # the CPU render in this process against the committed golden: the
    # comparison itself must reproduce the golden.
    "cpu_vs_golden": (1.0, 2.5e-4, 1e-5),
    # 3 or 4 of 14,400 pixels leave the band; 0.999 allows 14.
    "atrium_160x90/bvh": (0.999, 2.5e-4, 1e-5),
    "atrium_160x90/auto": (0.999, 2.5e-4, 1e-5),
    # against a float32 CPU render: no half-precision floor.
    "cornell_view/brute": (0.999, 1e-5, 1e-5),
    "cornell_view/auto": (0.999, 1e-5, 1e-5),
}
# The cornell_64 fixture has no bound on the GPU.  Its eye (0, 0, 2) lies
# on the floor (y = 0) and on the green wall (x = 0), so every primary
# ray hits at t = 0 (asserted below), and which coplanar triangle wins
# hangs on the sign of a barycentric coordinate that is zero in exact
# arithmetic.  The hit point rebuilt from barycentrics then lands off the
# other plane by a rounding error, on either side, so later bounces hang
# on rounding too.  Each compiler breaks these ties its own way: on the
# card the image means of the brute-force and the kernel renders lie 5%
# and 84% away from the CPU's (PERF.md).  The cornell scene is held to
# the band at CORNELL_CAMERA (cornell_view): the same settings, no ties.
CORNELL_VIEW = "cornell_view"

# Sharded gradient vs one-card gradient: per-pixel contributions are summed
# in another order (per-device partial sums, then psum; gather transposes
# accumulate with atomics), so the last bits differ.
GRAD_RTOL = 1e-4

CARD = ""


def say(phase, **fields):
    print(json.dumps(dict(phase=phase, card=CARD, **fields)), flush=True)


# ---------------------------------------------------------------------------
# Helpers shared with tools/gpu_intersector_timing.py
# ---------------------------------------------------------------------------


def primary_rays(cam, xres, yres):
    """Pixel-centre primary rays, planar (3, B0, 128) origins and dirs."""
    import jax.numpy as jnp
    import numpy as np

    from chiaroscuro_tpu.geometry.camera import (
        camera_basis,
        primary_ray_dirs_planar,
    )

    lu, dx, dy = camera_basis(np.asarray(cam["eye"], np.float32),
                              np.asarray(cam["center"], np.float32),
                              np.asarray(cam["up"], np.float32),
                              float(cam["yview"]), xres, yres)
    ys, xs = np.meshgrid(np.arange(yres, dtype=np.float32),
                         np.arange(xres, dtype=np.float32), indexing="ij")
    B = (xres * yres // 128, 128)
    half = np.full(B, 0.5, np.float32)
    d3 = primary_ray_dirs_planar(lu, dx, dy, xs.reshape(B), ys.reshape(B),
                                 half, half).astype(np.float32)
    o3 = np.broadcast_to(np.asarray(cam["eye"], np.float32)[:, None, None],
                         d3.shape)
    return jnp.asarray(o3), jnp.asarray(d3)


def shadow_rays(scene, ref, rows_o, rows_d):
    """Shadow rays from each closest hit toward the centroid of a light
    (lights taken in turn across rays); misses get tmax = 0."""
    import jax.numpy as jnp

    hit = jnp.asarray(ref["hit"])
    tid = jnp.asarray(ref["tid"])
    t = jnp.where(hit, jnp.asarray(ref["t"]), 0.0)
    point = rows_o + t[:, None] * rows_d
    origin = jnp.where(hit[:, None], point + 1e-3 * scene.normal[tid], rows_o)
    li = jnp.arange(rows_o.shape[0]) % scene.n_lights
    ltid = scene.light_ids[li]
    target = (scene.tri_v0[ltid] + scene.tri_v1[ltid] + scene.tri_v2[ltid]) / 3
    vec = target - origin
    dist = jnp.linalg.norm(vec, axis=1)
    return (origin, vec / dist[:, None], jnp.where(hit, dist, 0.0),
            ltid.astype(jnp.int32))


def compare_hits(ref, got):
    """Agreement of two closest-hit results (dicts of hit, t, tid)."""
    import numpy as np

    rh, gh = np.asarray(ref["hit"]), np.asarray(got["hit"])
    rt, gt = np.asarray(ref["t"]), np.asarray(got["t"])
    ri, gi = np.asarray(ref["tid"]), np.asarray(got["tid"])
    both = rh & gh
    rel = np.abs(gt - rt) / np.maximum(np.abs(rt), 1e-6)
    same = ri == gi
    tie = rel <= TIE_RTOL
    n = int(rh.size)
    hit_flip = int(np.sum(rh != gh))
    id_flip = int(np.sum(both & ~same & ~tie))
    t_off = int(np.sum(both & same & (rel > T_RTOL)))
    bad = hit_flip + id_flip + t_off
    return dict(rays=n, hits=int(rh.sum()), hit_flips=hit_flip,
                id_flips=id_flip, near_ties=int(np.sum(both & ~same & tie)),
                t_off=t_off,
                max_rel_t=float(rel[both & same].max(initial=0.0)),
                ok=bad <= FLIP_FRAC * n)


def _tolerance_text():
    return (f"hit/id/t agreement on all but {FLIP_FRAC:g} of rays: ids may "
            f"differ only at near-ties |dt| <= {TIE_RTOL:g}*t, t within "
            f"rtol {T_RTOL:g} on the same triangle; both sides are float32 "
            "Moller-Trumbore compiled by different compilers (Triton vs "
            "XLA), whose rounding differs in the last bits")


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_kernels():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from chiaroscuro_tpu.accel.bvh import build_bvh, bvh_any, bvh_closest
    from chiaroscuro_tpu.geometry.intersect import (
        intersect_any_bruteforce,
        intersect_closest_bruteforce,
    )
    from chiaroscuro_tpu.ops.cluster_pallas import make_cluster_intersectors
    from chiaroscuro_tpu.scene.scene_arrays import build_scene_arrays
    from chiaroscuro_tpu.scene.synthetic import ATRIUM_CAMERA, atrium

    say("kernels", tolerance=_tolerance_text())
    for n in KERNEL_ATRIA:
        t_setup = time.perf_counter()
        scene = jax.device_put(build_scene_arrays(atrium(n),
                                                  device_put=False))
        o3, d3 = primary_rays(ATRIUM_CAMERA, *FRAME)
        rows_o, rows_d = o3.reshape(3, -1).T, d3.reshape(3, -1).T
        cf, _ = make_cluster_intersectors(scene)
        bufs = cf.derive_buffers(scene)
        setup_s = time.perf_counter() - t_setup

        def closest(bufs, o, d):
            c, _ = cf.bind_buffers(bufs)
            r = c(o, d)
            return r.hit, r.t, r.tid

        def any_(bufs, o, d, tmax, excl):
            _, a = cf.bind_buffers(bufs)
            return a(o, d, tmax, excl)

        t0 = time.perf_counter()
        closest_c = jax.jit(closest).lower(bufs, rows_o, rows_d).compile()
        compile_s = time.perf_counter() - t0
        mem = closest_c.memory_analysis()
        got = closest_c(bufs, rows_o, rows_d)
        jax.block_until_ready(got)
        got = dict(hit=got[0], t=got[1], tid=got[2])

        bvh = build_bvh(scene)
        ref = jax.jit(bvh_closest)(bvh, rows_o, rows_d)
        ref = dict(hit=ref[0], t=ref[1], tid=ref[2])
        vs_bvh = compare_hits(ref, got)

        R = rows_o.shape[0]
        idx = np.linspace(0, R - 1, min(ORACLE_RAYS, R)).astype(np.int32)
        oh, ot, otid, _, _ = jax.jit(intersect_closest_bruteforce)(
            rows_o[idx], rows_d[idx], scene.tri_v0, scene.tri_v1,
            scene.tri_v2)
        vs_oracle = compare_hits(
            dict(hit=oh, t=ot, tid=otid),
            {k: np.asarray(v)[idx] for k, v in got.items()})

        so, sd, stmax, sexcl = shadow_rays(scene, ref, rows_o, rows_d)
        occ = jax.jit(any_)(bufs, so, sd, stmax, sexcl)
        occ_bvh = jax.jit(bvh_any)(bvh, so, sd, stmax, sexcl)
        occ_orc = jax.jit(intersect_any_bruteforce)(
            so[idx], sd[idx], scene.tri_v0, scene.tri_v1, scene.tri_v2,
            stmax[idx], sexcl[idx])
        occ = np.asarray(occ)
        any_vs_bvh = int(np.sum(occ != np.asarray(occ_bvh)))
        any_vs_oracle = int(np.sum(occ[idx] != np.asarray(occ_orc)))
        say("kernels", scene=f"atrium({n})", n_tris=scene.n_tris,
            wavefront=list(FRAME), setup_s=setup_s,
            closest_compile_s=compile_s,
            frame_step_memory=str(mem),
            closest_vs_bvh=vs_bvh, closest_vs_oracle_64k=vs_oracle,
            any_mismatch_vs_bvh=any_vs_bvh,
            any_mismatch_vs_oracle_64k=any_vs_oracle,
            occluded=int(occ.sum()))
        assert vs_bvh["ok"] and vs_oracle["ok"], (vs_bvh, vs_oracle)
        assert vs_bvh["hits"] > R // 2, "primary rays must mostly hit"
        assert any_vs_bvh <= FLIP_FRAC * R and any_vs_oracle <= FLIP_FRAC * R
        del bvh, bufs, scene


def phase_batch_render():
    import numpy as np

    from chiaroscuro_tpu import cli
    from chiaroscuro_tpu.render.image_io import read_exr

    path = os.path.join(OUT_DIR, "cornell_box.exr")
    if os.path.exists(path):
        os.remove(path)
    argv = ["chiaroscuro_tpu", os.path.join(ROOT, "scenes", "cornell.rtc"),
            "no-preview", "output", path, "samples", str(CORNELL_SPP),
            "xres", str(CORNELL_RES), "yres", str(CORNELL_RES)]
    t0 = time.perf_counter()
    assert cli.main(argv) == 0
    wall = time.perf_counter() - t0
    img = read_exr(path)
    assert img.shape == (CORNELL_RES, CORNELL_RES, 3), img.shape
    assert np.isfinite(img).all()
    # The ceiling light sits in the top quarter of the frame and is seen
    # directly (radiance > 1 there).
    top = img[: CORNELL_RES // 4].max()
    assert top > 1.0, top
    say("batch_render", scene="scenes/cornell.rtc",
        res=[CORNELL_RES, CORNELL_RES], k=6,
        samples=CORNELL_SPP, samples_cut_from=1000, wall_s=wall,
        mean=float(img.mean()), max=float(img.max()), output=path)


def phase_large_scene():
    import jax
    import numpy as np

    from chiaroscuro_tpu.render.renderer import Renderer
    from chiaroscuro_tpu.scene.config import RenderConfig
    from chiaroscuro_tpu.scene.scene_arrays import build_scene_arrays
    from chiaroscuro_tpu.scene.synthetic import ATRIUM_CAMERA as cam, atrium

    scene = jax.device_put(build_scene_arrays(atrium(LARGE_ATRIUM),
                                              device_put=False))
    cfg = RenderConfig(xres=FRAME[0], yres=FRAME[1], samples=1, k=3,
                       vp=cam["eye"], la=cam["center"], up=cam["up"],
                       yview=float(cam["yview"]), use_preview=False,
                       intersector="auto")
    t0 = time.perf_counter()
    r = Renderer(scene, cfg)
    img = r.ray_trace()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    img = r.ray_trace()   # second layer: compiled
    second = time.perf_counter() - t0
    assert np.isfinite(img).all() and img.mean() > 1e-3
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    say("large_scene", scene=f"atrium({LARGE_ATRIUM})", n_tris=scene.n_tris,
        intersector=_auto(scene), res=list(FRAME), spp=1, depth=3,
        first_frame_s=first, second_frame_s=second,
        useful_rays_per_sec=r.last_stats["useful_rays_per_sec"],
        peak_bytes_in_use=peak, mean=float(img.mean()))


def _auto(scene):
    import jax

    from chiaroscuro_tpu.accel.dispatch import resolve_auto

    return resolve_auto(scene.n_tris, jax.default_backend())


def _mean_error(img, ref):
    """(mean relative error, relative shift of the mean) of img vs ref."""
    import numpy as np

    return (float(np.abs(img - ref).mean() / np.abs(ref).mean()),
            float(abs(img.mean() - ref.mean()) / ref.mean()))


def _image_stats(img, ref):
    import numpy as np

    diff = np.abs(img - ref)
    band = np.all(diff <= GOLDEN_ATOL + GOLDEN_RTOL * np.abs(ref), axis=-1)
    rel, shift = _mean_error(img, ref)
    band_rel, band_shift = (_mean_error(img[band], ref[band]) if band.any()
                            else (None, None))
    out = np.argwhere(~band)
    return dict(
        in_band=float(band.mean()), band_mean_rel=band_rel,
        band_mean_shift=band_shift, image_mean_rel=rel,
        image_mean_shift=shift,
        # (row, col, largest channel difference) of the first pixels out
        out_of_band=[[int(y), int(x), float(diff[y, x].max())]
                     for y, x in out[:16]])


def _check_image(key, img, ref, **fields):
    import numpy as np

    assert img.shape == ref.shape and np.isfinite(img).all(), key
    st = _image_stats(img, ref)
    bound = GOLDEN_BOUNDS.get(key)
    say("goldens", compare=key, **fields, **st,
        rgb_means=dict(image=img.mean(axis=(0, 1)).tolist(),
                       reference=ref.mean(axis=(0, 1)).tolist()),
        band=dict(rtol=GOLDEN_RTOL, atol=GOLDEN_ATOL),
        bound=None if bound is None else dict(
            min_in_band=bound[0], max_band_mean_rel=bound[1],
            max_band_mean_shift=bound[2]))
    if bound is not None:
        assert st["in_band"] >= bound[0], (key, st)
        assert st["band_mean_rel"] <= bound[1], (key, st)
        assert st["band_mean_shift"] <= bound[2], (key, st)
    return st


def _fixture_view(spec):
    from chiaroscuro_tpu.scene.config import RenderConfig

    cfg = RenderConfig.from_tokens(["input", spec["scene"]])
    cam = dict(eye=cfg.vp, center=cfg.la, up=cfg.up, yview=cfg.yview)
    cam.update(spec.get("camera") or {})
    return cfg, cam


def _ray_ties(cfg, rays, gpu, cpu):
    """Closest hits of ``rays()`` ((R, 3) origins, dirs) through brute
    force on the CPU and through brute force and ``auto`` on the GPU: how
    many hit at t == 0, and which triangles win."""
    import jax
    import numpy as np

    from chiaroscuro_tpu.accel import make_intersectors
    from chiaroscuro_tpu.scene.scene_arrays import load_scene

    out = {}
    for label, dev, method in (("cpu brute", cpu, "brute"),
                               ("gpu brute", gpu, "brute"),
                               ("gpu auto", gpu, "auto")):
        with jax.default_device(dev):
            scene = load_scene(cfg)
            cf, _ = make_intersectors(scene, method)
            hit, t, tid = jax.jit(lambda o, d: tuple(cf(o, d))[:3])(*rays())
        hit, t, tid = (np.asarray(x) for x in (hit, t, tid))
        tid = np.where(hit, tid, -1)
        out[label] = dict(hits=int(hit.sum()),
                          hits_at_t0=int(np.sum(hit & (t == 0))),
                          same_triangle_as_cpu=int(np.sum(
                              tid == out.get("cpu brute", {}).get("tid",
                                                                  tid))),
                          triangles=_counts(tid), tid=tid)
    for v in out.values():
        del v["tid"]
    return dict(rays=int(tid.size), **out)


def _primary_ties(spec, gpu, cpu):
    """Pixel-centre primary rays of a fixture's view."""
    cfg, cam = _fixture_view(spec)

    def rays():
        o3, d3 = primary_rays(cam, spec["xres"], spec["yres"])
        return o3.reshape(3, -1).T, d3.reshape(3, -1).T

    return _ray_ties(cfg, rays, gpu, cpu)


def _counts(tid):
    import numpy as np

    ids, n = np.unique(tid, return_counts=True)
    return {str(int(i)): int(k) for i, k in zip(ids, n)}


def phase_goldens():
    import jax

    from chiaroscuro_tpu.render.image_io import read_exr
    from chiaroscuro_tpu.scene.builtin import CORNELL_CAMERA
    from tools.make_goldens import FIXTURES, GOLDEN_DIR, render_fixture

    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]

    def render(spec, dev, intersector):
        with jax.default_device(dev):
            return render_fixture("", dict(spec, intersector=intersector),
                                  cpu=False)

    for name in ("cornell_64", "atrium_160x90"):
        spec = FIXTURES[name]
        golden = read_exr(os.path.join(GOLDEN_DIR, f"{name}.exr"))
        own = spec["intersector"]
        _check_image("cpu_vs_golden", render(spec, cpu, own), golden,
                     fixture=name, intersector=own, device="cpu")
        for method in (own, "auto"):
            _check_image(f"{name}/{method}", render(spec, gpu, method),
                         golden, fixture=name, intersector=method,
                         device="gpu")

    spec = FIXTURES["cornell_64"]
    ties = _primary_ties(spec, gpu, cpu)
    say("goldens", fixture="cornell_64", primary_rays=ties)
    # The witness behind leaving cornell_64 unbounded on the GPU: every
    # primary ray of its view starts on a surface.
    assert ties["cpu brute"]["hits_at_t0"] == ties["rays"], ties
    view = dict(spec, camera=CORNELL_CAMERA)
    say("goldens", fixture=CORNELL_VIEW, primary_rays=_primary_ties(
        view, gpu, cpu))
    ref = render(view, cpu, "brute")
    for method in ("brute", "auto"):
        _check_image(f"{CORNELL_VIEW}/{method}", render(view, gpu, method),
                     ref, fixture=CORNELL_VIEW, intersector=method,
                     device="gpu", reference="cpu brute")


def phase_inverse():
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from chiaroscuro_tpu.accel import make_intersectors
    from chiaroscuro_tpu.render.renderer import render_samples
    from chiaroscuro_tpu.scene.builtin import CORNELL_CAMERA as cam
    from chiaroscuro_tpu.scene.builtin import cornell_box
    from chiaroscuro_tpu.scene.scene_arrays import build_scene_arrays

    scene = build_scene_arrays(cornell_box())
    cf, af = make_intersectors(scene, "auto")
    res = 256
    ys, xs = np.meshgrid(np.arange(res, dtype=np.int32),
                         np.arange(res, dtype=np.int32), indexing="ij")
    args = (np.asarray(cam["eye"], np.float32),
            np.asarray(cam["center"], np.float32),
            np.asarray(cam["up"], np.float32), float(cam["yview"]),
            res, res, xs.reshape(-1), ys.reshape(-1))

    def render(s):
        return render_samples(s, *args, jnp.int32(0), 4, np.uint32(1), 3,
                              np.zeros(3, np.float32), cf, af)

    target = jax.jit(render)(scene)

    def loss(params):
        s = dataclasses.replace(scene, **params)
        return jnp.mean((render(s) - target) ** 2)

    # Start from a darkened, emission-scaled scene; Adam pulls it back.
    params = {"kd": scene.kd * 0.6, "ke": scene.ke * 1.5}
    opt = optax.adam(0.05)
    state = opt.init(params)
    vg = jax.jit(jax.value_and_grad(loss))
    losses = []
    t0 = time.perf_counter()
    for _ in range(3):
        l, g = vg(params)
        for k, v in g.items():
            assert np.isfinite(np.asarray(v)).all(), k
        losses.append(float(l))
        upd, state = opt.update(g, state, params)
        params = optax.apply_updates(params, upd)
    losses.append(float(vg(params)[0]))
    say("inverse", scene="cornell", res=[res, res], spp=4, depth=3,
        steps=3, losses=losses, wall_s=time.perf_counter() - t0)
    assert losses[-1] < losses[0], losses


def phase_gpu_tests():
    import pytest

    t0 = time.perf_counter()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests")])
    say("gpu_tests", rc=int(rc), wall_s=time.perf_counter() - t0)
    assert rc == 0, f"pytest -m gpu exited {rc}"


def phase_sharded(n_dev):
    """Tile-sharded render bitwise equal to the one-card render, and the
    psum'd gradient equal to the one-card gradient, with the production
    intersector."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from chiaroscuro_tpu.accel import make_intersectors
    from chiaroscuro_tpu.parallel.sharding import (
        make_tile_mesh,
        render_frame_sharded,
        sharded_value_and_grad,
    )
    from chiaroscuro_tpu.scene.scene_arrays import build_scene_arrays
    from chiaroscuro_tpu.scene.synthetic import ATRIUM_CAMERA as cam, atrium

    devs = jax.devices()
    assert len(devs) >= n_dev, f"need {n_dev} devices, have {len(devs)}"
    scene = build_scene_arrays(atrium(20_000))
    method = _auto(scene)
    cf, af = make_intersectors(scene, "auto")
    xres, yres, spp, depth = 256, 144, 2, 3
    view = (jnp.asarray(cam["eye"], jnp.float32),
            jnp.asarray(cam["center"], jnp.float32),
            jnp.asarray(cam["up"], jnp.float32),
            jnp.float32(cam["yview"]))
    frames = {}
    for n in (1, n_dev):
        t0 = time.perf_counter()
        frames[n] = np.asarray(render_frame_sharded(
            scene, make_tile_mesh(devs[:n]), *view, xres, yres, spp,
            jnp.uint32(0), depth, jnp.zeros(3, jnp.float32), cf, af))
        say("sharded_render", devices=n, intersector=method,
            res=[xres, yres], spp=spp, depth=depth,
            wall_s=time.perf_counter() - t0, mean=float(frames[n].mean()))
    bitwise = bool(np.array_equal(frames[1], frames[n_dev]))
    say("sharded_render", bitwise_equal_1_vs_n=bitwise, n=n_dev)
    assert np.isfinite(frames[1]).all() and frames[1].mean() > 1e-3
    assert bitwise

    ys, xs = np.meshgrid(np.arange(yres, dtype=np.int32),
                         np.arange(xres, dtype=np.int32), indexing="ij")
    px, py = jnp.asarray(xs.reshape(-1)), jnp.asarray(ys.reshape(-1))
    kwargs = dict(zip(("eye", "center", "up", "yview"), view),
                  xres=xres, yres=yres, sample_start=jnp.int32(0),
                  n_samples=1, seed=jnp.uint32(0), depth=depth,
                  background=jnp.zeros(3, jnp.float32),
                  closest_fn=cf, any_fn=af)
    make = sharded_value_and_grad(lambda img: jnp.mean((img - 0.25) ** 2))
    grads = {}
    for n in (1, n_dev):
        run = jax.jit(make(make_tile_mesh(devs[:n]), kwargs))
        t0 = time.perf_counter()
        loss, g = run(scene, px, py)
        grads[n] = (float(loss), {k: np.asarray(v) for k, v in g.items()})
        say("sharded_grad", devices=n, loss=grads[n][0],
            wall_s=time.perf_counter() - t0)
    l1, g1 = grads[1]
    ln, gn = grads[n_dev]
    worst = {}
    for k in g1:
        assert np.isfinite(gn[k]).all(), k
        scale = float(np.abs(g1[k]).max()) or 1.0
        worst[k] = float(np.max(np.abs(gn[k] - g1[k])) / scale)
    say("sharded_grad", rtol=GRAD_RTOL, loss_1=l1, loss_n=ln,
        max_abs_diff_over_max_grad=worst, n=n_dev)
    assert abs(ln - l1) <= GRAD_RTOL * abs(l1)
    for k in g1:
        np.testing.assert_allclose(gn[k], g1[k], rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(g1[k]).max())


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="4: run only the sharded render and gradient")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"no GPU: JAX sees {devs[0].platform} devices only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from chiaroscuro_tpu.utils.compile_cache import enable_compile_cache
    from chiaroscuro_tpu.utils.devinfo import card_line, jax_device

    CARD = card_line()
    print(CARD, flush=True)
    device = jax_device()
    say("device", device=device, compile_cache=enable_compile_cache())
    os.makedirs(OUT_DIR, exist_ok=True)

    if args.devices > 1:
        phases = [functools.partial(phase_sharded, args.devices)]
    else:
        phases = [phase_kernels, phase_batch_render, phase_large_scene,
                  phase_goldens, phase_inverse, phase_gpu_tests]
    for ph in phases:
        t0 = time.perf_counter()
        ph()
        say("phase_done", name=getattr(ph, "__name__", "phase_sharded"),
            wall_s=time.perf_counter() - t0)

    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
