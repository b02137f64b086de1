"""Intersector selection: brute-force oracle, BVH walk or cluster kernel.

The integrator (``render/integrator.py``) is agnostic to how rays are
intersected; this module picks the backend:

- ``"brute"``  — masked all-pairs Moller-Trumbore in XLA (exact oracle;
  the small-scene path off the GPU and the correctness reference for
  everything else);
- ``"bvh"``    — flattened BVH walked in lock step by the whole wavefront
  (``accel/bvh.py``), the structural analog of the reference's kd-tree
  (``src/kdtree.cpp``) — the large-scene path off the GPU;
- ``"cluster"``— XLA meshlet cull + Triton visit kernel
  (``ops/cluster_pallas.py``) — the large-scene path on the GPU;
- ``"dense"``  — the same kernel without the cull, every ray row visiting
  every cluster — the small-scene path on the GPU;
- ``"auto"``   — picks by platform and scene size (:func:`resolve_auto`).
"""

from __future__ import annotations

import warnings
from typing import Tuple

from chiaroscuro_tpu.geometry.intersect import (
    AnyFn,
    ClosestFn,
    ClosestHit,
    intersect_any_bruteforce,
    intersect_closest_bruteforce,
)
from chiaroscuro_tpu.scene.scene_arrays import SceneArrays

# Off the GPU: above this triangle count the BVH walk beats the XLA
# brute-force sweep.
AUTO_BVH_THRESHOLD = 4096

# The cluster path stores triangle ids as exact float32 values and caps at
# 2^24 tris (ops/cluster_pallas.py ID_SENTINEL); beyond that auto degrades
# to the lock-step BVH walk rather than raise, and warns loudly about it.
CLUSTER_MAX_TRIS = 2**24


def resolve_auto(n_tris: int, platform: str) -> str:
    """The ``"auto"`` backend decision for a scene of ``n_tris`` triangles
    on a JAX platform (``"gpu"``, ``"cpu"``, ...).

    On the GPU the visit kernel beat the XLA paths at every size measured
    (H100; CHANGES.md, PR 1): a scene that fits one cluster has nothing to
    cull and takes the dense sweep, a larger one the culled kernel."""
    if platform != "gpu":
        return "brute" if n_tris <= AUTO_BVH_THRESHOLD else "bvh"
    from chiaroscuro_tpu.ops.cluster_pallas import cluster_size

    if n_tris <= cluster_size(n_tris):
        return "dense"
    if n_tris < CLUSTER_MAX_TRIS:
        return "cluster"
    warnings.warn(
        f"scene has {n_tris} triangles >= 2^24: the cluster intersector's "
        "float32 triangle ids cannot represent it, degrading to the "
        "lock-step BVH walk, which is far slower on the GPU. Split the "
        "scene or reduce triangle count.",
        RuntimeWarning, stacklevel=3,
    )
    return "bvh"


def make_intersectors(
    scene: SceneArrays, method: str = "auto", chunk: int = 2048
) -> Tuple[ClosestFn, AnyFn]:
    if method == "auto":
        import jax

        method = resolve_auto(scene.n_tris, jax.default_backend())

    if method == "brute":
        from chiaroscuro_tpu.utils.hostconst import host_const

        # Host constants when concrete (no lowering-time device fetch,
        # utils/hostconst.py); tracers pass through for the grad path.
        tv0 = host_const(scene.tri_v0)
        tv1 = host_const(scene.tri_v1)
        tv2 = host_const(scene.tri_v2)

        def closest_fn(origins, dirs) -> ClosestHit:
            hit, t, tid, u, v = intersect_closest_bruteforce(
                origins, dirs, tv0, tv1, tv2, chunk
            )
            return ClosestHit(hit, t, tid, u, v)

        def any_fn(origins, dirs, tmax, exclude_id):
            return intersect_any_bruteforce(
                origins, dirs, tv0, tv1, tv2, tmax, exclude_id, chunk
            )

        return closest_fn, any_fn

    if method == "bvh":
        from chiaroscuro_tpu.accel.bvh import build_bvh, make_bvh_intersectors

        bvh = build_bvh(scene)
        return make_bvh_intersectors(scene, bvh)

    if method in ("cluster", "dense"):
        from chiaroscuro_tpu.ops.cluster_pallas import make_cluster_intersectors

        return make_cluster_intersectors(scene, cull=method == "cluster")

    raise ValueError(f"unknown intersector method: {method!r}")
