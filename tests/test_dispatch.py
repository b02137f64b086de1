"""Auto-dispatch decision + documented degradation warnings.

The intersector is chosen from what the code can observe: the platform and
the scene's triangle count.  The >2^24-triangle fall-back from the cluster
path to the lock-step BVH walk and the 1024-light shadow-sort-key clamp
both warn; the selection logic is unit-tested here.
"""

import warnings

import pytest

from chiaroscuro_tpu.accel.dispatch import (
    AUTO_BVH_THRESHOLD,
    CLUSTER_MAX_TRIS,
    resolve_auto,
)
from chiaroscuro_tpu.ops.cluster_pallas import SMALL_M as CLUSTER_M


def test_auto_selection_matrix():
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # none of these may warn
        assert resolve_auto(36, "gpu") == "dense"
        assert resolve_auto(36, "cpu") == "brute"
        assert resolve_auto(19_058, "gpu") == "cluster"
        assert resolve_auto(19_058, "cpu") == "bvh"
        assert resolve_auto(CLUSTER_MAX_TRIS - 1, "gpu") == "cluster"
        assert resolve_auto(AUTO_BVH_THRESHOLD, "cpu") == "brute"


@pytest.mark.parametrize("n_tris,platform,expected", [
    (1, "gpu", "dense"),
    (CLUSTER_M, "gpu", "dense"),
    (CLUSTER_M + 1, "gpu", "cluster"),
    (480_000, "gpu", "cluster"),
    (AUTO_BVH_THRESHOLD + 1, "cpu", "bvh"),
    (CLUSTER_M + 1, "cpu", "brute"),
    (480_000, "cpu", "bvh"),
])
def test_platform_dispatch_matrix(n_tris, platform, expected):
    """Only the GPU gets the kernel; every other platform keeps the XLA
    paths (the kernel has no compiled form there)."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert resolve_auto(n_tris, platform) == expected


def test_over_2pow24_degrades_to_bvh_with_warning():
    with pytest.warns(RuntimeWarning, match="2\\^24"):
        assert resolve_auto(CLUSTER_MAX_TRIS, "gpu") == "bvh"
    with pytest.warns(RuntimeWarning, match="far slower"):
        assert resolve_auto(CLUSTER_MAX_TRIS + 7, "gpu") == "bvh"
    # Off the GPU the BVH is the normal large-scene path: no warning.
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert resolve_auto(CLUSTER_MAX_TRIS + 7, "cpu") == "bvh"


@pytest.mark.parametrize("method", ["cluster", "dense"])
def test_kernel_request_off_gpu_raises(cornell_scene, method):
    """An explicit kernel request on the CPU fails loudly instead of
    silently running the interpreter."""
    from chiaroscuro_tpu.accel import make_intersectors

    with pytest.raises(ValueError, match="GPU only"):
        make_intersectors(cornell_scene, method)


def test_shadow_sort_light_clamp_warns():
    """trace_paths_planar warns once per trace when the spatial shadow sort
    runs with > 1024 area lights (sort-key ids alias beyond that)."""
    import dataclasses

    import numpy as np

    from chiaroscuro_tpu.accel import make_intersectors
    from chiaroscuro_tpu.render.renderer import render_samples
    from chiaroscuro_tpu.scene.builtin import CORNELL_CAMERA, cornell_box
    from chiaroscuro_tpu.scene.scene_arrays import build_scene_arrays

    scene = build_scene_arrays(cornell_box())
    cf, af = make_intersectors(scene, "brute")
    cf.prefers_ray_sort = True  # force the spatial-sort path

    def render(s):
        cam = CORNELL_CAMERA
        ys, xs = np.meshgrid(np.arange(8, dtype=np.int32),
                             np.arange(8, dtype=np.int32), indexing="ij")
        return render_samples(
            s, np.asarray(cam["eye"], np.float32),
            np.asarray(cam["center"], np.float32),
            np.asarray(cam["up"], np.float32), float(cam["yview"]),
            8, 8, xs.reshape(-1), ys.reshape(-1), np.int32(0), 1,
            np.uint32(0), 2, np.zeros(3, np.float32), cf, af, compact=True,
        )

    # n_lights is static metadata; fake the count past the clamp (the
    # light-id array still holds valid ids, lookups stay in range via the
    # integrator's min(li, n_lights-1) — only the warning path is probed).
    import jax.numpy as jnp

    many = dataclasses.replace(
        scene,
        n_lights=1500,
        light_ids=jnp.asarray(np.resize(np.asarray(scene.light_ids), 1500)),
        light_areas=jnp.asarray(
            np.resize(np.asarray(scene.light_areas), 1500)
        ),
    )
    with pytest.warns(RuntimeWarning, match="1024"):
        render(many)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        render(scene)  # 2 cornell lights: no warning
