"""The cluster-visit kernel compiled for the GPU, against the oracle.

The CPU tests run the same kernel in the Pallas interpreter; these compile
it with Triton and run it on the card.  Marked ``gpu``: without a card
they skip (decided in the ``gpu`` fixture, never at import).  Run them on
the card with ``python -m pytest -m gpu tests``; ``chip_smoke.py`` runs
them as its last phase.
"""

import dataclasses

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; JAX sees none")
    return jax


@pytest.mark.parametrize("cull,ray_block", [(True, 128), (True, 32),
                                            (False, 128)])
def test_cluster_kernel_compiled_matches_oracle(gpu, rng, cull, ray_block):
    import jax.numpy as jnp

    from chiaroscuro_tpu.geometry.intersect import (
        intersect_any_bruteforce,
        intersect_closest_bruteforce,
    )
    from chiaroscuro_tpu.ops.cluster_pallas import make_cluster_intersectors
    from test_cluster import _random_soup, _rays, _soup_scene

    v0, v1, v2 = _random_soup(rng, 3000)
    scene = _soup_scene(v0, v1, v2)
    cf, af = make_cluster_intersectors(scene, M=32, Lmax=8, cull=cull,
                                       ray_block=ray_block)
    o, d = _rays(rng, 5000, np.float32(-4.4), np.float32(4.4))
    res = cf(o, d)
    oh, ot, otid, _, _ = intersect_closest_bruteforce(
        o, d, scene.tri_v0, scene.tri_v1, scene.tri_v2)
    hit = np.asarray(oh)
    # Triton and XLA round Moller-Trumbore differently in the last bits:
    # allow a few edge grazes to flip, ids to differ only at near-ties.
    assert np.sum(np.asarray(res.hit) != hit) <= 2
    both = hit & np.asarray(res.hit)
    t, tr = np.asarray(res.t)[both], np.asarray(ot)[both]
    np.testing.assert_allclose(t, tr, rtol=1e-4)
    same = np.asarray(res.tid)[both] == np.asarray(otid)[both]
    assert (same | np.isclose(t, tr, rtol=1e-5)).all()

    tmax = jnp.asarray(rng.uniform(0.5, 10.0, (5000,)), jnp.float32)
    excl = jnp.asarray(rng.integers(0, 3000, (5000,)), jnp.int32)
    occ = np.asarray(af(o, d, tmax, excl))
    ref = np.asarray(intersect_any_bruteforce(
        o, d, scene.tri_v0, scene.tri_v1, scene.tri_v2, tmax, excl))
    assert np.sum(occ != ref) <= 2


def test_cluster_render_and_grads_compiled_match_brute(gpu, cornell_scene):
    """A small differentiable render through the compiled kernel equals the
    brute-force render, and so do its kd/ke gradients."""
    import jax
    import jax.numpy as jnp

    from chiaroscuro_tpu.accel import make_intersectors
    from chiaroscuro_tpu.ops.cluster_pallas import make_cluster_intersectors
    from chiaroscuro_tpu.render.renderer import render_samples
    from chiaroscuro_tpu.scene.builtin import CORNELL_CAMERA as cam

    scene = cornell_scene
    ys, xs = np.meshgrid(np.arange(32, dtype=np.int32),
                         np.arange(32, dtype=np.int32), indexing="ij")
    px, py = jnp.asarray(xs.reshape(-1)), jnp.asarray(ys.reshape(-1))

    def loss_for(cf, af):
        def loss(params):
            s = dataclasses.replace(scene, **params)
            img = render_samples(
                s, jnp.asarray(cam["eye"], jnp.float32),
                jnp.asarray(cam["center"], jnp.float32),
                jnp.asarray(cam["up"], jnp.float32),
                jnp.float32(cam["yview"]), 32, 32, px, py, jnp.int32(0), 2,
                jnp.uint32(0), 3, jnp.zeros(3, jnp.float32), cf, af)
            return jnp.mean(img)
        return loss

    params = {"kd": scene.kd, "ke": scene.ke}
    lc, gc = jax.jit(jax.value_and_grad(loss_for(
        *make_cluster_intersectors(scene, M=16, Lmax=4))))(params)
    lb, gb = jax.jit(jax.value_and_grad(loss_for(
        *make_intersectors(scene, "brute"))))(params)
    np.testing.assert_allclose(float(lc), float(lb), rtol=1e-3)
    for k in params:
        g = np.asarray(gc[k])
        assert np.isfinite(g).all(), k
        np.testing.assert_allclose(g, np.asarray(gb[k]), rtol=1e-2,
                                   atol=1e-3 * np.abs(np.asarray(gb[k])).max())


def test_nee_light_fetch_is_exact_on_gpu(gpu, cornell_scene):
    """The NEE light-row fetch is a gather: the rows it returns are the
    light table's own float32 values, bit for bit (no TF32 rounding)."""
    import jax
    import jax.numpy as jnp

    scene = cornell_scene
    lids = scene.light_ids
    table = jnp.concatenate([scene.tri_v0[lids], scene.ke[lids]], axis=1).T
    li = jnp.arange(4096, dtype=jnp.int32) % scene.n_lights
    rows = jax.jit(lambda t, i: t[:, i])(table, li)
    np.testing.assert_array_equal(
        np.asarray(rows), np.asarray(table)[:, np.asarray(li)])
