"""The Pallas visit kernel as a dense sweep (no cull) vs the oracle.

Without the cull every row of rays visits every cluster: the kernel is
then a brute-force sweep over the scene, here the 36-triangle cornell box.
The kernel runs in the Pallas interpreter on CPU; tests/test_gpu.py and
chip_smoke.py run it compiled on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from chiaroscuro_tpu.geometry.intersect import (
    intersect_any_bruteforce,
    intersect_closest_bruteforce,
)
from chiaroscuro_tpu.ops.cluster_pallas import make_cluster_intersectors
from chiaroscuro_tpu.scene.builtin import cornell_box
from chiaroscuro_tpu.scene.scene_arrays import build_scene_arrays


@pytest.fixture(scope="module")
def setup(rng=None):
    scene = build_scene_arrays(cornell_box())
    closest_fn, any_fn = make_cluster_intersectors(
        scene, interpret=True, cull=False)
    return scene, closest_fn, any_fn


def _rays(scene, rng, n):
    lo = np.asarray(scene.world_min)
    hi = np.asarray(scene.world_max)
    o = rng.uniform(lo - 0.1 * (hi - lo), hi + 0.1 * (hi - lo), (n, 3))
    d = rng.normal(size=(n, 3))
    return jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)


def test_pallas_closest_matches_oracle(setup, rng):
    scene, closest_fn, _ = setup
    o, d = _rays(scene, rng, 300)  # non-multiple of 128: tests padding
    ph, pt, ptid, pu, pv = closest_fn(o, d)[:5]
    oh, ot, otid, ou, ov = intersect_closest_bruteforce(
        o, d, scene.tri_v0, scene.tri_v1, scene.tri_v2
    )
    np.testing.assert_array_equal(np.asarray(ph), np.asarray(oh))
    hit = np.asarray(oh)
    np.testing.assert_allclose(
        np.asarray(pt)[hit], np.asarray(ot)[hit], rtol=1e-6
    )
    same = np.asarray(ptid)[hit] == np.asarray(otid)[hit]
    ties = np.isclose(np.asarray(pt)[hit], np.asarray(ot)[hit], rtol=1e-6)
    assert (same | ties).all()
    np.testing.assert_allclose(
        np.asarray(pu)[hit][same], np.asarray(ou)[hit][same], rtol=1e-5,
        atol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(pv)[hit][same], np.asarray(ov)[hit][same], rtol=1e-5,
        atol=1e-6,
    )


def test_pallas_any_matches_oracle(setup, rng):
    scene, _, any_fn = setup
    o, d = _rays(scene, rng, 300)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    tmax = jnp.asarray(rng.uniform(10, 1200, 300), jnp.float32)
    excl = jnp.asarray(rng.integers(0, scene.n_tris, 300), jnp.int32)
    p = any_fn(o, d, tmax, excl)
    ref = intersect_any_bruteforce(
        o, d, scene.tri_v0, scene.tri_v1, scene.tri_v2, tmax, excl
    )
    np.testing.assert_array_equal(np.asarray(p), np.asarray(ref))


def test_pallas_render_matches_brute(setup):
    from chiaroscuro_tpu.accel.dispatch import make_intersectors
    from chiaroscuro_tpu.render.renderer import render_image
    from chiaroscuro_tpu.scene.builtin import CORNELL_CAMERA
    from chiaroscuro_tpu.scene.config import RenderConfig

    scene, closest_fn, any_fn = setup
    cam = CORNELL_CAMERA
    cfg = RenderConfig(
        xres=8, yres=8, k=2, samples=2, seed=0,
        vp=cam["eye"], la=cam["center"], up=cam["up"], yview=cam["yview"],
    )
    brute = np.asarray(
        render_image(scene, cfg, intersectors=make_intersectors(scene, "brute"))
    )
    pall = np.asarray(
        render_image(scene, cfg, intersectors=(closest_fn, any_fn))
    )
    np.testing.assert_allclose(pall, brute, rtol=1e-5, atol=1e-6)


def test_pallas_attrs_match_scene_gathers(setup, rng):
    """The attribute rows gathered by tid after the kernel == gathering
    the scene fields by tid."""
    scene, closest_fn, _ = setup
    o, d = _rays(scene, rng, 300)
    res = closest_fn(o, d)
    assert res.attrs is not None
    hit = np.asarray(res.hit)
    tid = np.asarray(res.tid)[hit]
    A = {k: np.asarray(v)[hit] for k, v in res.attrs.items()}
    np.testing.assert_allclose(A["v0"], np.asarray(scene.tri_v0)[tid], rtol=1e-6)
    np.testing.assert_allclose(
        A["e1"], np.asarray(scene.tri_v1)[tid] - np.asarray(scene.tri_v0)[tid],
        rtol=1e-6,
    )
    np.testing.assert_allclose(A["normal"], np.asarray(scene.normal)[tid], atol=1e-6)
    np.testing.assert_allclose(A["kd"], np.asarray(scene.kd)[tid], rtol=1e-6)
    np.testing.assert_allclose(A["ke"], np.asarray(scene.ke)[tid], rtol=1e-6)
    np.testing.assert_array_equal(A["btype"], np.asarray(scene.brdf_type)[tid])
    np.testing.assert_array_equal(A["texid"], np.asarray(scene.tex_id)[tid])


def test_pallas_gradients_match_bruteforce():
    """The custom-VJP kernel path must reproduce brute-force gradients of a
    pixel loss w.r.t. material color, emission, and vertex positions."""
    import dataclasses

    import jax

    from chiaroscuro_tpu.accel.clusters import build_clusters
    from chiaroscuro_tpu.accel.dispatch import make_intersectors
    from chiaroscuro_tpu.render.renderer import render_samples

    scene = build_scene_arrays(cornell_box())
    eye = jnp.asarray([0.0, 1.0, 3.2], jnp.float32)
    center = jnp.asarray([0.0, 1.0, 0.0], jnp.float32)
    up = jnp.asarray([0.0, 1.0, 0.0], jnp.float32)
    xres = yres = 16
    ys, xs = np.meshgrid(
        np.arange(yres, dtype=np.int32), np.arange(xres, dtype=np.int32),
        indexing="ij",
    )
    px = jnp.asarray(xs.reshape(-1))
    py = jnp.asarray(ys.reshape(-1))

    def make_loss(method):
        def loss(params):
            s = dataclasses.replace(scene, **params)
            if method == "pallas":
                cf, af = make_cluster_intersectors(
                    s, interpret=True, cull=False,
                    clusters=build_clusters(
                        np.asarray(scene.tri_v0), np.asarray(scene.tri_v1),
                        np.asarray(scene.tri_v2), 16))
            else:
                cf, af = make_intersectors(s, "brute")
            img = render_samples(
                s, eye, center, up, jnp.float32(1.0), xres, yres, px, py,
                jnp.int32(0), 2, jnp.uint32(3), 3,
                jnp.zeros(3, jnp.float32), cf, af,
            )
            return jnp.mean(img * jnp.linspace(0.5, 1.5, img.size).reshape(img.shape))
        return loss

    params = {"kd": scene.kd, "ke": scene.ke, "tri_v0": scene.tri_v0}
    g_pallas = jax.grad(make_loss("pallas"))(params)
    g_brute = jax.grad(make_loss("brute"))(params)

    for k in params:
        a, b = np.asarray(g_pallas[k]), np.asarray(g_brute[k])
        assert np.isfinite(a).all(), k
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=1e-6, err_msg=k)
