"""Time the Triton cluster-visit kernel against the plain XLA paths on a GPU.

    python tools/gpu_intersector_timing.py kernels  # check + shape sweep
    python tools/gpu_intersector_timing.py render   # end-to-end frames
    python tools/gpu_intersector_timing.py shapes   # kernel shapes, frames

``kernels``: on the 480k- and 20k-triangle atria, a 1280x720 primary-ray
wavefront and the matching shadow wavefront.  For each kernel shape
(ray block, cluster size M, register-tile width, warps) it compiles the
closest-hit and any-hit queries, checks them against the lock-step BVH on
the whole frame and against the brute-force oracle on a 64k-ray subset,
and times them beside the BVH.

``render``: whole frames through ``render_samples`` (1280x720, 1 spp,
depth 3), one compiled program per intersector, timed in turns:
cluster vs lock-step BVH on both atria, and the dense kernel (cluster
without the cull) vs the XLA brute-force sweep vs the culled kernel on
cornell 512x512 (4 spp) and ``atrium(4_000)``.

``shapes``: the same whole frames on both atria for several kernel
shapes.

Every line names the card and its power limit.  Results also go to
``chiprun_out/intersector_timing.jsonl``.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, "chiprun_out", "intersector_timing.jsonl")

KERNEL_ATRIA = (480_000, 20_000)
FRAME = (1280, 720)


def _emit(rec):
    from chiaroscuro_tpu.utils.devinfo import card_line

    rec = dict(rec, card=card_line())
    line = json.dumps(rec)
    print(line, flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


def _time(fn, *args, reps=5):
    """(compile+first seconds, best steady seconds) of fn(*args)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return first, best, out


def _atrium(n):
    import jax

    from chiaroscuro_tpu.scene.scene_arrays import build_scene_arrays
    from chiaroscuro_tpu.scene.synthetic import ATRIUM_CAMERA, atrium

    return jax.device_put(build_scene_arrays(atrium(n), device_put=False)), \
        ATRIUM_CAMERA


def kernels():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from chip_smoke import compare_hits, primary_rays, shadow_rays
    from chiaroscuro_tpu.accel.bvh import build_bvh, bvh_any, bvh_closest
    from chiaroscuro_tpu.accel.clusters import build_clusters
    from chiaroscuro_tpu.ops import cluster_pallas as cp

    shapes = [  # (ray_block, M, SUB, num_warps)
        (128, 128, 16, 4),
        (128, 64, 16, 4),
        (64, 64, 16, 4),
        (32, 64, 16, 2),
        (32, 32, 32, 1),
        (128, 128, 8, 4),
    ]
    for n in KERNEL_ATRIA:
        scene, cam = _atrium(n)
        o3, d3 = primary_rays(cam, *FRAME)
        rows_o, rows_d = o3.reshape(3, -1).T, d3.reshape(3, -1).T
        bvh = build_bvh(scene)
        fb, tb, ref = _time(jax.jit(bvh_closest), bvh, rows_o, rows_d)
        ref = dict(hit=ref[0], t=ref[1], tid=ref[2])
        so, sd, stmax, sexcl = shadow_rays(scene, ref, rows_o, rows_d)
        fba, tba, occ_ref = _time(jax.jit(bvh_any), bvh, so, sd, stmax, sexcl)
        _emit(dict(tool="kernels", scene=f"atrium({n})", n_tris=scene.n_tris,
                   path="bvh", closest_ms=tb * 1e3, any_ms=tba * 1e3,
                   compile_s=fb + fba))
        clusters = {}
        for rb, M, sub, warps in shapes:
            if M not in clusters:
                clusters[M] = build_clusters(
                    np.asarray(scene.tri_v0), np.asarray(scene.tri_v1),
                    np.asarray(scene.tri_v2), M)
            cf, af = _with_shape((rb, M, sub, warps),
                                 cp.make_cluster_intersectors, scene,
                                 clusters=clusters[M])
            bufs = cf.derive_buffers(scene)

            @jax.jit
            def closest(bufs, o, d):
                c, _ = cf.bind_buffers(bufs)
                r = c(o, d)
                return r.hit, r.t, r.tid

            @jax.jit
            def any_(bufs, o, d, tmax, excl):
                _, a = cf.bind_buffers(bufs)
                return a(o, d, tmax, excl)

            rec = dict(tool="kernels", scene=f"atrium({n})", K=clusters[M].K,
                       ray_block=rb, M=M, SUB=sub, num_warps=warps)
            try:
                fc, tc, got = _time(closest, bufs, rows_o, rows_d)
                fa, ta, occ = _time(any_, bufs, so, sd, stmax, sexcl)
            except Exception as e:  # a shape the compiler refuses
                _emit(dict(rec, error=f"{type(e).__name__}: {e}"[:2000]))
                continue
            got = dict(hit=got[0], t=got[1], tid=got[2])
            cmp_bvh = compare_hits(ref, got)
            occ_mis = int(np.sum(np.asarray(occ) != np.asarray(occ_ref)))
            _emit(dict(rec, closest_ms=tc * 1e3, any_ms=ta * 1e3,
                       compile_s=fc + fa, vs_bvh=cmp_bvh,
                       any_mismatch_vs_bvh=occ_mis))
        del bvh


def _frame(scene, cam, closest_fn, xres, yres, spp, depth):
    """Jitted whole frame; intersector buffers passed as jit arguments."""
    import jax
    import numpy as np

    from chiaroscuro_tpu.render.renderer import render_samples

    ys, xs = np.meshgrid(np.arange(yres, dtype=np.int32),
                         np.arange(xres, dtype=np.int32), indexing="ij")
    args = (np.asarray(cam["eye"], np.float32),
            np.asarray(cam["center"], np.float32),
            np.asarray(cam["up"], np.float32), float(cam["yview"]),
            xres, yres, xs.reshape(-1), ys.reshape(-1))
    bind = getattr(closest_fn, "bind_buffers", None)
    if bind is None:
        cf, af = closest_fn

        @jax.jit
        def frame(scene, bufs, s0):
            return render_samples(scene, *args, s0, spp, np.uint32(0), depth,
                                  np.zeros(3, np.float32), cf, af)

        return frame, ()

    @jax.jit
    def frame(scene, bufs, s0):
        cf, af = bind(bufs)
        return render_samples(scene, *args, s0, spp, np.uint32(0), depth,
                              np.zeros(3, np.float32), cf, af)

    return frame, closest_fn.derive_buffers(scene)


def _with_shape(shape, fn, *args, **kw):
    """fn(*args, **kw) with the kernel shape forced to ``shape``
    (ray_block, M, SUB, warps); None keeps the module's constants."""
    from chiaroscuro_tpu.ops import cluster_pallas as cp

    names = ("RAY_BLOCK", "cluster_size", "SUB", "NUM_WARPS")
    orig = [getattr(cp, n) for n in names]
    if shape is not None:
        rb, M, sub, warps = shape
        for n, v in zip(names, (rb, lambda t: M, sub, warps)):
            setattr(cp, n, v)
    try:
        return fn(*args, **kw)
    finally:
        for n, v in zip(names, orig):
            setattr(cp, n, v)


def _kernel(cull=True, shape=None):
    """Builder of kernel intersectors at a (ray_block, M, SUB, warps) shape
    (None: the module's shape for the scene)."""
    from chiaroscuro_tpu.ops import cluster_pallas as cp

    def build(scene):
        cf, _ = _with_shape(shape, cp.make_cluster_intersectors, scene,
                            cull=cull)
        return cf

    return build


def _xla(method):
    from chiaroscuro_tpu.accel import make_intersectors

    return lambda scene: make_intersectors(scene, method)


def _render_cases(cases):
    """Each case: (name, scene maker, xres, yres, spp, [(label, builder)]).
    Every builder's frame is compiled first, then all are timed in turns
    (a, b, ..., b, a), twice; the best time of each is reported."""
    import jax
    import jax.numpy as jnp

    for name, make, xres, yres, spp, variants in cases:
        scene, cam = make()
        frames = {}
        for label, build in variants:
            t0 = time.perf_counter()
            fn, bufs = _frame(scene, cam, build(scene), xres, yres, spp, 3)
            jax.block_until_ready(fn(scene, bufs, jnp.int32(0)))
            frames[label] = (fn, bufs, time.perf_counter() - t0)
        labels = [v[0] for v in variants]
        best = {m: float("inf") for m in labels}
        for rep in range(2):
            for m in labels + labels[::-1]:
                fn, bufs, _ = frames[m]
                t0 = time.perf_counter()
                jax.block_until_ready(fn(scene, bufs, jnp.int32(rep + 1)))
                best[m] = min(best[m], time.perf_counter() - t0)
        for m in labels:
            _emit(dict(tool="render", scene=name, n_tris=scene.n_tris,
                       res=[xres, yres], spp=spp, depth=3, path=m,
                       frame_ms=best[m] * 1e3, compile_s=frames[m][2]))


def _cornell():
    import jax

    from chiaroscuro_tpu.scene.builtin import CORNELL_CAMERA, cornell_box
    from chiaroscuro_tpu.scene.scene_arrays import build_scene_arrays

    return (jax.device_put(build_scene_arrays(cornell_box(),
                                              device_put=False)),
            CORNELL_CAMERA)


def render():
    """Kernel vs XLA paths, whole frames."""
    _render_cases([
        (f"atrium({n})", lambda n=n: _atrium(n), *FRAME, 1,
         [("cluster", _kernel()), ("bvh", _xla("bvh"))])
        for n in KERNEL_ATRIA
    ] + [
        ("atrium(4000)", lambda: _atrium(4_000), *FRAME, 1,
         [("dense", _kernel(cull=False)), ("brute", _xla("brute")),
          ("cluster", _kernel())]),
        ("cornell", _cornell, 512, 512, 4,
         [("dense", _kernel(cull=False)), ("brute", _xla("brute")),
          ("cluster", _kernel())]),
    ])


SHAPES = [(128, 128, 8, 4), (64, 128, 8, 4), (32, 128, 8, 2),
          (32, 64, 16, 2), (32, 64, 8, 2)]


def shapes():
    """Kernel shapes (ray_block, M, SUB, warps), whole frames."""
    _render_cases([
        (f"atrium({n})", lambda n=n: _atrium(n), *FRAME, 1,
         [(f"cluster{sh}", _kernel(shape=sh)) for sh in SHAPES])
        for n in KERNEL_ATRIA
    ])


if __name__ == "__main__":
    from chiaroscuro_tpu.utils.compile_cache import enable_compile_cache
    from chiaroscuro_tpu.utils.devinfo import card_line, jax_device

    import jax

    if jax.devices()[0].platform != "gpu":
        sys.exit("no GPU: these timings are taken on the card only")
    print("cache:", enable_compile_cache(), "| device:", jax_device(),
          "| card:", card_line(), flush=True)
    {"kernels": kernels, "render": render, "shapes": shapes}[sys.argv[1]]()
