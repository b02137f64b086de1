"""Integrator tests: analytic expectations, camera parity, e2e cornell."""

import jax.numpy as jnp
import numpy as np
import pytest

from chiaroscuro_tpu.accel import make_intersectors
from chiaroscuro_tpu.geometry.camera import camera_basis
from chiaroscuro_tpu.render.renderer import render_image, render_samples
from chiaroscuro_tpu.scene.builtin import CORNELL_CAMERA, cornell_box
from chiaroscuro_tpu.scene.config import RenderConfig
from chiaroscuro_tpu.scene.obj_loader import Mesh
from chiaroscuro_tpu.scene.scene_arrays import build_scene_arrays


def _mesh_from_tris(name, tris, kd, ke=(0, 0, 0)):
    tris = np.asarray(tris, np.float32)
    positions = tris.reshape(-1, 3)
    normals = []
    indices = []
    for i, t in enumerate(tris):
        n = np.cross(t[1] - t[0], t[2] - t[0])
        n = n / np.linalg.norm(n)
        normals += [n, n, n]
        indices.append((3 * i, 3 * i + 1, 3 * i + 2))
    return Mesh(
        name=name,
        positions=positions,
        normals=np.asarray(normals, np.float32),
        uvs=np.zeros((len(positions), 2), np.float32),
        indices=np.asarray(indices, np.int32),
        diffuse=np.asarray(kd, np.float32),
        emissive=np.asarray(ke, np.float32),
        ambient=np.zeros(3, np.float32),
        specular=np.zeros(3, np.float32),
        shininess=0.0,
    )


def _cfg(scene_dummy=None, **kw):
    base = dict(
        xres=8, yres=8, k=2, samples=16, seed=0, intersector="brute",
        vp=(0, 0, 2), la=(0, 0, 0), up=(0, 1, 0), yview=1.0,
    )
    base.update(kw)
    return RenderConfig(**base)


def test_camera_basis_matches_glm_lookat():
    """Check against hand-computed glm::lookAt for an off-axis camera."""
    eye = np.array([1.0, 2.0, 3.0])
    center = np.array([0.0, 0.5, -1.0])
    up = np.array([0.0, 1.0, 0.0])
    lu, dx, dy = camera_basis(eye, center, up, 1.0, 200, 100)
    f = (center - eye) / np.linalg.norm(center - eye)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    y = 0.5
    x = y * 2.0  # xres/yres = 2
    np.testing.assert_allclose(np.asarray(lu), -x * s + y * u + f, atol=1e-6)
    np.testing.assert_allclose(np.asarray(dx), (2 * x / 200) * s, atol=1e-6)
    np.testing.assert_allclose(np.asarray(dy), -(2 * y / 100) * u, atol=1e-6)


def test_primary_emission_head_on():
    """A big emissive wall fills the view: pixel = Ke * dot(wo, n)
    (rayTracer.cpp:85); NEE onto the emitter itself adds ~0 (coplanar)."""
    ke = (2.0, 3.0, 4.0)
    wall = _mesh_from_tris(
        "wall:light",
        [
            [(-10, -10, 0), (10, -10, 0), (10, 10, 0)],
            [(-10, -10, 0), (10, 10, 0), (-10, 10, 0)],
        ],
        (0.1, 0.1, 0.1),
        ke,
    )
    scene = build_scene_arrays([wall])
    cfg = _cfg(k=1, samples=8, xres=4, yres=4)
    img = np.asarray(render_image(scene, cfg))
    # Every pixel sees the wall: ratio to Ke = cos of the view angle, which
    # stays above cos(~atan(0.7)) for this 4x4 frame's corner rays.
    ratios = img / np.asarray(ke)
    assert np.all(ratios > 0.8) and np.all(ratios <= 1.0 + 1e-5)
    # All three channels share the same cosine factor.
    np.testing.assert_allclose(ratios[..., 0], ratios[..., 2], rtol=1e-5)


def test_nee_matches_quadrature():
    """Depth-1 direct lighting on a diffuse floor equals numerical
    integration of the reference estimator over the light-point density
    v0~U(0,1), v1~U(0,1-v0) (rayTracer.cpp:89-111)."""
    # Winding chosen so the flat normal points +y (toward camera and light).
    floor = _mesh_from_tris(
        "floor:white",
        [
            [(-5, 0, -5), (5, 0, 5), (5, 0, -5)],
            [(-5, 0, -5), (-5, 0, 5), (5, 0, 5)],
        ],
        (0.8, 0.6, 0.4),
    )
    l0, l1, l2 = (-0.5, 3.0, -0.5), (0.5, 3.0, -0.5), (0.0, 3.0, 0.5)
    light = _mesh_from_tris("l:light", [[l0, l1, l2]], (1, 1, 1), (5.0, 5.0, 5.0))
    scene = build_scene_arrays([floor, light])
    assert scene.n_lights == 1

    # Straight-down camera so the primary hit lands near the origin.
    cfg = _cfg(
        k=1, samples=4096, xres=2, yres=2,
        vp=(0.0, 1.0, 0.0), la=(0.0, 0.0, 0.0), up=(0.0, 0.0, 1.0), yview=0.02,
    )
    img = np.asarray(render_image(scene, cfg))

    # Quadrature over the reference's (v0, v1) density at hit point ~origin.
    rng = np.random.default_rng(0)
    v0s = rng.uniform(0, 1, 200000)
    v1s = rng.uniform(0, 1, 200000) * (1 - v0s)
    lp = (
        v0s[:, None] * np.asarray(l0)
        + v1s[:, None] * np.asarray(l1)
        + (1 - v0s - v1s)[:, None] * np.asarray(l2)
    )
    hit = np.zeros(3)
    d = np.linalg.norm(lp - hit, axis=1)
    wl = (lp - hit) / d[:, None]
    n = np.array([0.0, 1.0, 0.0])
    ln = np.cross(np.subtract(l1, l0), np.subtract(l2, l0))
    ln = ln / np.linalg.norm(ln)  # (0, -1, 0) or (0, 1, 0) by winding
    geom = np.maximum(0.0, (wl @ n) * (-(wl) @ ln) / (1 + d * d))
    area = 0.5 * np.linalg.norm(np.cross(np.subtract(l1, l0), np.subtract(l2, l0)))
    expected = 5.0 * geom.mean() * area * 1 * (np.asarray([0.8, 0.6, 0.4]) / np.pi)

    mc = img.reshape(-1, 3).mean(axis=0)
    np.testing.assert_allclose(mc, expected, rtol=0.05)


def test_depth_cap_no_indirect():
    """k=1 yields zero indirect: a mirror-dark box lit only via bounces is
    black at depth 1 but bright at depth 3."""
    scene = build_scene_arrays(cornell_box())
    cam = CORNELL_CAMERA
    cfg1 = _cfg(
        k=1, samples=16, xres=8, yres=8,
        vp=cam["eye"], la=cam["center"], up=cam["up"], yview=cam["yview"],
    )
    cfg3 = _cfg(
        k=3, samples=16, xres=8, yres=8,
        vp=cam["eye"], la=cam["center"], up=cam["up"], yview=cam["yview"],
    )
    img1 = np.asarray(render_image(scene, cfg1))
    img3 = np.asarray(render_image(scene, cfg3))
    assert img3.mean() > img1.mean() > 0.0


def test_background_on_miss():
    """Rays that miss everything return the background at full throughput."""
    tiny = _mesh_from_tris(
        "t:white", [[(100, 100, 100), (101, 100, 100), (100, 101, 100)]], (1, 1, 1)
    )
    scene = build_scene_arrays([tiny])
    cfg = _cfg(k=2, samples=4, xres=4, yres=4, background=(0.25, 0.5, 0.75))
    img = np.asarray(render_image(scene, cfg))
    np.testing.assert_allclose(
        img, np.broadcast_to([0.25, 0.5, 0.75], img.shape), atol=1e-6
    )


def test_cornell_e2e_sanity(cornell_scene):
    """64x64 cornell: light ~ Ke, red/green wall tint, interior lit."""
    cam = CORNELL_CAMERA
    cfg = _cfg(
        k=3, samples=32, xres=64, yres=64,
        vp=cam["eye"], la=cam["center"], up=cam["up"], yview=cam["yview"],
    )
    img = np.asarray(render_image(cornell_scene, cfg))
    assert np.isfinite(img).all() and img.min() >= 0.0
    # The light patch shows Ke * cos(view angle) ~ 20 * 0.25 ~ 5 on primary
    # hits (rayTracer.cpp:85 weights emission by dot(wo, n)).
    assert img.max() > 3.0
    # Camera looks down +z with up +y: viewer right = world -x, so the red
    # wall (x=556) is image-left and the green wall (x=0) image-right.
    left = img[16:48, :16].mean(axis=(0, 1))
    right = img[16:48, -16:].mean(axis=(0, 1))
    assert left[0] > left[1]  # red tint on the left
    assert right[1] > right[0]  # green tint on the right
    # Interior receives light (cm-scale scene under the reference's
    # 1/(1+d^2) falloff is dim in absolute terms; exposure compensates).
    assert img[24:40, 24:40].mean() > 0.005


def test_render_deterministic(cornell_scene):
    cam = CORNELL_CAMERA
    cfg = _cfg(
        k=2, samples=4, xres=16, yres=16,
        vp=cam["eye"], la=cam["center"], up=cam["up"], yview=cam["yview"],
    )
    a = np.asarray(render_image(cornell_scene, cfg))
    b = np.asarray(render_image(cornell_scene, cfg))
    np.testing.assert_array_equal(a, b)


def test_tile_invariance(cornell_scene):
    """Rendering in tiles is bitwise identical to the full frame — the
    counter-based PRNG contract that makes sharding exact."""
    cam = CORNELL_CAMERA
    cfg = _cfg(
        k=2, samples=2, xres=16, yres=8,
        vp=cam["eye"], la=cam["center"], up=cam["up"], yview=cam["yview"],
    )
    full = np.asarray(render_image(cornell_scene, cfg))

    closest_fn, any_fn = make_intersectors(cornell_scene, "brute")
    ys, xs = np.meshgrid(np.arange(8), np.arange(16), indexing="ij")
    xs, ys = xs.reshape(-1).astype(np.int32), ys.reshape(-1).astype(np.int32)
    halves = []
    for sl in (slice(0, 64), slice(64, 128)):
        tile = render_samples(
            cornell_scene,
            jnp.asarray(cam["eye"], jnp.float32),
            jnp.asarray(cam["center"], jnp.float32),
            jnp.asarray(cam["up"], jnp.float32),
            jnp.float32(cam["yview"]),
            16, 8,
            jnp.asarray(xs[sl]), jnp.asarray(ys[sl]),
            0, 2, jnp.uint32(0), 2,
            jnp.zeros(3, jnp.float32),
            closest_fn, any_fn,
        )
        halves.append(np.asarray(tile))
    tiled = np.concatenate(halves).reshape(8, 16, 3)
    np.testing.assert_array_equal(full, tiled)


def test_sample_chunking_invariance(cornell_scene):
    """spp_chunk changes arithmetic order only by exact partial sums of the
    same per-sample values -> allclose (and typically bitwise)."""
    cam = CORNELL_CAMERA
    kw = dict(
        k=2, xres=8, yres=8,
        vp=cam["eye"], la=cam["center"], up=cam["up"], yview=cam["yview"],
    )
    full = np.asarray(render_image(cornell_scene, _cfg(samples=8, **kw)))
    chunked = np.asarray(
        render_image(cornell_scene, _cfg(samples=8, spp_chunk=2, **kw))
    )
    np.testing.assert_allclose(full, chunked, rtol=1e-5, atol=1e-6)


def test_spp_batch_equivalence(cornell_scene):
    """spp_batch folds samples into one wide wavefront: every (pixel,
    sample) PRNG stream is unchanged, so the mean image matches the
    sequential scan to accumulation-order ulp, and the (exact-integer)
    useful-work stats match bitwise."""
    cam = CORNELL_CAMERA
    ys, xs = np.meshgrid(
        np.arange(16, dtype=np.int32), np.arange(16, dtype=np.int32),
        indexing="ij",
    )
    px, py = xs.reshape(-1), ys.reshape(-1)
    cf, af = make_intersectors(cornell_scene, "brute")

    def render(spp_batch, sample_start=0):
        return render_samples(
            cornell_scene,
            np.asarray(cam["eye"], np.float32),
            np.asarray(cam["center"], np.float32),
            np.asarray(cam["up"], np.float32), float(cam["yview"]),
            16, 16, px, py, np.int32(sample_start), 8, np.uint32(3), 3,
            np.zeros(3, np.float32), cf, af, with_stats=True,
            spp_batch=spp_batch,
        )

    img1, st1 = render(1)
    for sb in (2, 8):
        imgb, stb = render(sb)
        np.testing.assert_allclose(
            np.asarray(imgb), np.asarray(img1), rtol=2e-5, atol=1e-6
        )
        np.testing.assert_array_equal(np.asarray(stb), np.asarray(st1))
    # Non-dividing spp_batch silently degrades to sequential (bitwise).
    img3, _ = render(3)
    np.testing.assert_array_equal(np.asarray(img3), np.asarray(img1))
    # sample_start offsets compose with batching (progressive layers).
    imgo, _ = render(4, sample_start=8)
    imgo1, _ = render(1, sample_start=8)
    np.testing.assert_allclose(
        np.asarray(imgo), np.asarray(imgo1), rtol=2e-5, atol=1e-6
    )


def test_compaction_bitwise_identity(cornell_scene):
    """Bounce-ray compaction (integrator ``compact=True``) must be a pure
    lane permutation: per-pixel radiance bitwise-identical to the
    uncompacted wavefront, on both the brute oracle and the kernel path.

    ``compact`` is forced through ``render_samples``' own parameter (the
    previous ``partial(trace_paths_planar, compact=...)`` monkeypatch was
    silently overridden by the call-site keyword — advisor r4 coverage
    finding)."""
    cam = CORNELL_CAMERA
    ys, xs = np.meshgrid(
        np.arange(24, dtype=np.int32), np.arange(24, dtype=np.int32),
        indexing="ij",
    )
    px, py = xs.reshape(-1), ys.reshape(-1)
    from chiaroscuro_tpu.ops.cluster_pallas import make_cluster_intersectors

    for method in ("brute", "kernel"):
        if method == "kernel":
            cf, af = make_cluster_intersectors(
                cornell_scene, M=8, interpret=True)
        else:
            cf, af = make_intersectors(cornell_scene, method)
        outs = {}
        for compact in (False, True):
            outs[compact] = np.asarray(
                render_samples(
                    cornell_scene,
                    np.asarray(cam["eye"], np.float32),
                    np.asarray(cam["center"], np.float32),
                    np.asarray(cam["up"], np.float32),
                    float(cam["yview"]), 24, 24,
                    px, py, np.int32(0), 4, np.uint32(3), 4,
                    np.zeros(3, np.float32), cf, af, compact=compact,
                )
            )
        np.testing.assert_array_equal(outs[False], outs[True]), method


def test_spatial_sort_bitwise_identity_cluster():
    """The cluster path's correctness-critical permutation machinery —
    global spatial bounce sort + per-light shadow sort (_sorted_any) — must
    leave radiance bitwise-identical to the unsorted wavefront.

    ``COMPACT_MIN_K`` gates ``prefers_ray_sort`` off for every CI-sized
    scene, so this new r4 code otherwise has zero CI coverage (advisor r4
    medium finding); lower the gate so the multi-light atrium engages the
    full sort pipeline (the int state bit-rides the stacked gather as
    f32)."""
    import chiaroscuro_tpu.ops.cluster_pallas as cp
    from chiaroscuro_tpu.scene.synthetic import ATRIUM_CAMERA, atrium

    scene = build_scene_arrays(atrium(2_200, seed=5))
    assert scene.n_lights > 1  # _sorted_any's light-id key must matter
    cam = ATRIUM_CAMERA
    xres = yres = 16
    ys, xs = np.meshgrid(np.arange(yres, dtype=np.int32),
                         np.arange(xres, dtype=np.int32), indexing="ij")
    px, py = xs.reshape(-1), ys.reshape(-1)
    cf, af = cp.make_cluster_intersectors(scene, interpret=True)

    def render(compact):
        return np.asarray(
            render_samples(
                scene,
                np.asarray(cam["eye"], np.float32),
                np.asarray(cam["center"], np.float32),
                np.asarray(cam["up"], np.float32), float(cam["yview"]),
                xres, yres, px, py, np.int32(0), 2, np.uint32(7), 3,
                np.zeros(3, np.float32), cf, af, compact=compact,
            )
        )

    baseline = render(compact=False)
    assert np.isfinite(baseline).all() and baseline.mean() > 1e-4

    orig_min_k = cp.COMPACT_MIN_K
    try:
        # Gate the sorts ON for this tiny scene: render_samples re-binds the
        # intersectors per trace, and _finalize re-reads COMPACT_MIN_K, so
        # the forced preference reaches the post-bind closures too.
        cp.COMPACT_MIN_K = 1
        cfc, afc = cp.make_cluster_intersectors(scene, interpret=True)
        assert cfc.prefers_compaction and cfc.prefers_ray_sort
        sorted_out = np.asarray(
            render_samples(
                scene,
                np.asarray(cam["eye"], np.float32),
                np.asarray(cam["center"], np.float32),
                np.asarray(cam["up"], np.float32), float(cam["yview"]),
                xres, yres, px, py, np.int32(0), 2, np.uint32(7), 3,
                np.zeros(3, np.float32), cfc, afc, compact=True,
            )
        )
        np.testing.assert_array_equal(baseline, sorted_out)
    finally:
        cp.COMPACT_MIN_K = orig_min_k


def test_nee_light_gather_matches_onehot_product(cornell_scene):
    """NEE fetches the sampled light's row with a plain gather.  It must
    return exactly what the one-hot product it replaced returned at full
    float32 precision — each one-hot column sums one 1.0 * value."""
    import jax
    import jax.numpy as jnp

    scene = cornell_scene
    lids = scene.light_ids
    table = jnp.concatenate(
        [scene.tri_v0[lids], scene.tri_v1[lids], scene.tri_v2[lids],
         scene.normal[lids], scene.ke[lids], scene.light_areas[:, None]],
        axis=1,
    ).T                                                     # (16, L)
    li = jax.random.randint(jax.random.PRNGKey(3), (8, 128), 0,
                            scene.n_lights)
    gathered = table[:, li.reshape(-1)]
    onehot = (jnp.arange(scene.n_lights)[:, None]
              == li.reshape(-1)[None, :]).astype(jnp.float32)
    product = jnp.dot(table, onehot, precision=jax.lax.Precision.HIGHEST)
    np.testing.assert_array_equal(np.asarray(gathered), np.asarray(product))
