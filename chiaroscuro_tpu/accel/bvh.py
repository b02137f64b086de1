"""Flattened BVH: host-side SAH build + stackless threaded traversal.

Array-program replacement for the reference's recursive kd-tree
(``src/kdtree.cpp:110-344``).  Design rationale:

- **Build on host, once, at scene-load time** (numpy) — the reference builds
  its tree on the CPU too (``kdtree.cpp:34-108``); construction is not a hot
  loop.  Binned-SAH over centroids with leaf size = the scene's
  ``kdtree-leaf-size`` knob (``scene.cpp:64``, default 8).
- **Threaded ("skip-link") layout for stackless traversal**: nodes are stored
  in DFS order; each node carries a ``miss_link`` (escape) index.  A ray's
  entire traversal state is ONE node index: on box hit advance to ``i+1``,
  on miss jump to ``miss_link[i]``, sentinel ends the walk.  No per-ray
  stack, fixed-shape state, pure gathers — exactly what ``lax.while_loop``
  over a ray wavefront (and later a Pallas kernel) wants.  This replaces the
  reference's recursive near-to-far traversal with tmin/tmax interval
  splitting (``kdtree.cpp:248-281``); ordering is approximated by DFS order
  of an SAH tree and closest-hit pruning uses the running ``t_best`` as the
  box-test tmax.
- **Leaf triangles are re-ordered contiguously** so a leaf is a (start,
  count<=leaf_size) range into permuted triangle arrays: leaf processing is a
  dense vectorized Moller-Trumbore over ``leaf_size`` gathered triangles,
  masked by actual count.

Exactness: a BVH visits a superset ordering of intersections vs the kd-tree
but computes the same closest hit; the brute-force oracle tests in
``tests/test_bvh.py`` assert bitwise-equal (t, id, u, v) against
``geometry/intersect.py``.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from chiaroscuro_tpu.geometry.intersect import AnyFn, ClosestFn, ClosestHit, FLT_EPS
from chiaroscuro_tpu.scene.scene_arrays import SceneArrays

SENTINEL = np.int32(-1)


@dataclasses.dataclass
class BVHArrays:
    """Flattened threaded BVH, device-resident SoA."""

    bbox_min: jax.Array    # (N, 3) f32
    bbox_max: jax.Array    # (N, 3) f32
    miss_link: jax.Array   # (N,) i32 node to jump to when the box test fails
    leaf_start: jax.Array  # (N,) i32 start into tri_order, -1 for internal
    leaf_count: jax.Array  # (N,) i32 triangles in the leaf (0 for internal)
    tri_order: jax.Array   # (T_padded,) i32 permutation of triangle ids
    # Pre-gathered, reordered triangle geometry (leaf-contiguous):
    tri_v0: jax.Array      # (T_padded, 3) f32
    tri_e1: jax.Array      # (T_padded, 3) f32  v1 - v0
    tri_e2: jax.Array      # (T_padded, 3) f32  v2 - v0
    n_nodes: int = dataclasses.field(metadata=dict(static=True), default=0)
    leaf_size: int = dataclasses.field(metadata=dict(static=True), default=8)


jax.tree_util.register_dataclass(
    BVHArrays,
    data_fields=[
        "bbox_min", "bbox_max", "miss_link", "leaf_start", "leaf_count",
        "tri_order", "tri_v0", "tri_e1", "tri_e2",
    ],
    meta_fields=["n_nodes", "leaf_size"],
)


# ---------------------------------------------------------------------------
# Host-side build (numpy)
# ---------------------------------------------------------------------------

N_BINS = 16


def _build_host(
    v0: np.ndarray, v1: np.ndarray, v2: np.ndarray, leaf_size: int
) -> Tuple[np.ndarray, ...]:
    T = len(v0)
    tri_min = np.minimum(np.minimum(v0, v1), v2)
    tri_max = np.maximum(np.maximum(v0, v1), v2)
    centroid = (tri_min + tri_max) * 0.5

    # Node arrays, grown as python lists of tuples then stacked.
    bbox_min, bbox_max = [], []
    leaf_start, leaf_count = [], []
    right_child = []  # index of second child, -1 for leaf (DFS: first = i+1)
    tri_order: list = []

    def surface(mn, mx):
        d = np.maximum(mx - mn, 0.0)
        return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    def build(ids: np.ndarray) -> int:
        node = len(bbox_min)
        mn = tri_min[ids].min(axis=0)
        mx = tri_max[ids].max(axis=0)
        bbox_min.append(mn)
        bbox_max.append(mx)
        leaf_start.append(-1)
        leaf_count.append(0)
        right_child.append(-1)

        if len(ids) <= leaf_size:
            leaf_start[node] = len(tri_order)
            leaf_count[node] = len(ids)
            tri_order.extend(ids.tolist())
            return node

        # Binned SAH over the widest centroid axis.
        c = centroid[ids]
        cmin, cmax = c.min(axis=0), c.max(axis=0)
        extent = cmax - cmin
        axis = int(extent.argmax())
        if extent[axis] <= 0.0:
            # All centroids coincide: split evenly to guarantee progress.
            half = len(ids) // 2
            left_ids, right_ids = ids[:half], ids[half:]
        else:
            scale = N_BINS * (1.0 - 1e-6) / extent[axis]
            bins = ((c[:, axis] - cmin[axis]) * scale).astype(np.int32)
            # Bin bounds + counts.
            counts = np.bincount(bins, minlength=N_BINS)
            bmn = np.full((N_BINS, 3), np.inf)
            bmx = np.full((N_BINS, 3), -np.inf)
            for b in range(N_BINS):
                sel = bins == b
                if counts[b]:
                    bmn[b] = tri_min[ids[sel]].min(axis=0)
                    bmx[b] = tri_max[ids[sel]].max(axis=0)
            # Sweep: cost(split after bin k) = SA_L*N_L + SA_R*N_R.
            best_cost, best_k = np.inf, -1
            lmn, lmx = np.full(3, np.inf), np.full(3, -np.inf)
            lcounts = np.zeros(N_BINS)
            lsa = np.zeros(N_BINS)
            for k in range(N_BINS - 1):
                if counts[k]:
                    lmn = np.minimum(lmn, bmn[k])
                    lmx = np.maximum(lmx, bmx[k])
                lcounts[k] = counts[: k + 1].sum()
                lsa[k] = surface(lmn, lmx) if lcounts[k] else 0.0
            rmn, rmx = np.full(3, np.inf), np.full(3, -np.inf)
            for k in range(N_BINS - 2, -1, -1):
                if counts[k + 1]:
                    rmn = np.minimum(rmn, bmn[k + 1])
                    rmx = np.maximum(rmx, bmx[k + 1])
                rc = counts[k + 1 :].sum()
                if lcounts[k] == 0 or rc == 0:
                    continue
                cost = lsa[k] * lcounts[k] + surface(rmn, rmx) * rc
                if cost < best_cost:
                    best_cost, best_k = cost, k
            if best_k < 0:
                half = len(ids) // 2
                order = np.argsort(c[:, axis], kind="stable")
                left_ids, right_ids = ids[order[:half]], ids[order[half:]]
            else:
                sel = bins <= best_k
                left_ids, right_ids = ids[sel], ids[~sel]

        build(left_ids)  # first child at node+1 (DFS)
        right_child[node] = build(right_ids)
        return node

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        build(np.arange(T))
    finally:
        sys.setrecursionlimit(old_limit)

    n = len(bbox_min)
    right = np.asarray(right_child, np.int32)
    ls = np.asarray(leaf_start, np.int32)
    lc = np.asarray(leaf_count, np.int32)

    # miss links: traversal in DFS order; node i's subtree spans [i, end_i).
    # miss_link[i] = end of subtree (next node after it), SENTINEL at root.
    miss = np.full(n, SENTINEL, np.int32)

    def thread(node: int, escape: int) -> None:
        # Iterative DFS to avoid recursion limits on deep trees.
        stack = [(node, escape)]
        while stack:
            i, esc = stack.pop()
            miss[i] = esc
            if lc[i] == 0:  # internal: children are i+1 and right[i]
                stack.append((i + 1, right[i]))
                stack.append((right[i], esc))

    thread(0, int(SENTINEL))

    return (
        np.asarray(bbox_min, np.float32),
        np.asarray(bbox_max, np.float32),
        miss,
        ls,
        lc,
        np.asarray(tri_order, np.int32),
    )


def _build_host_native(v0, v1, v2, leaf_size):
    """C++ builder (native/bvh_builder.cpp) via ctypes; same layout and split
    policy as :func:`_build_host`.  Returns None if the library is missing."""
    from chiaroscuro_tpu.native import bvh_lib

    lib = bvh_lib()
    if lib is None:
        return None
    import ctypes

    T = len(v0)
    cap = 2 * max(T, 1)
    bmin = np.empty((cap, 3), np.float32)
    bmax = np.empty((cap, 3), np.float32)
    miss = np.empty(cap, np.int32)
    ls = np.empty(cap, np.int32)
    lc = np.empty(cap, np.int32)
    order = np.empty(max(T, 1), np.int32)
    n_nodes = np.zeros(1, np.int32)

    def fp(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    def ip(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    c0 = np.ascontiguousarray(v0, np.float32)
    c1 = np.ascontiguousarray(v1, np.float32)
    c2 = np.ascontiguousarray(v2, np.float32)
    rc = lib.bvh_build(
        fp(c0), fp(c1), fp(c2), T, leaf_size,
        fp(bmin), fp(bmax), ip(miss), ip(ls), ip(lc), ip(order),
        ip(n_nodes),
    )
    if rc != 0:
        return None
    n = int(n_nodes[0])
    return bmin[:n], bmax[:n], miss[:n], ls[:n], lc[:n], order[:T]


def build_bvh(
    scene: SceneArrays, leaf_size: int = 8, native: bool = True
) -> BVHArrays:
    v0 = np.asarray(scene.tri_v0)
    v1 = np.asarray(scene.tri_v1)
    v2 = np.asarray(scene.tri_v2)
    built = _build_host_native(v0, v1, v2, leaf_size) if native else None
    if built is None:
        built = _build_host(v0, v1, v2, leaf_size)
    bmin, bmax, miss, ls, lc, order = built

    # Pad tri_order to a multiple of leaf_size with a degenerate slot so the
    # fixed-width leaf gather never reads OOB.
    pad = (-len(order)) % max(leaf_size, 1) + leaf_size
    order_p = np.concatenate([order, np.zeros(pad, np.int32)])

    ov0 = v0[order_p]
    ov1 = v1[order_p]
    ov2 = v2[order_p]
    # Zero out padding so padded lanes can never hit (a == 0 -> miss).
    ov0[len(order):] = 0
    ov1[len(order):] = 0
    ov2[len(order):] = 0

    # Host (numpy) arrays: jitted callers capture the BVH as closure
    # constants, and host constants lower without the device->host fetch
    # that device-array constants pay per trace (utils/hostconst.py).
    return BVHArrays(
        bbox_min=np.asarray(bmin),
        bbox_max=np.asarray(bmax),
        miss_link=np.asarray(miss),
        leaf_start=np.asarray(ls),
        leaf_count=np.asarray(lc),
        tri_order=np.asarray(order_p),
        tri_v0=np.asarray(ov0),
        tri_e1=np.asarray(ov1 - ov0),
        tri_e2=np.asarray(ov2 - ov0),
        n_nodes=len(bmin),
        leaf_size=leaf_size,
    )


# ---------------------------------------------------------------------------
# Device-side traversal (lax.while_loop over the ray wavefront)
# ---------------------------------------------------------------------------

def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def _leaf_intersect(bvh: BVHArrays, origins, dirs, start, count, t_best):
    """Vectorized Moller-Trumbore over each ray's ``leaf_size`` leaf slots.

    origins/dirs: (R, 3); start/count: (R,).  Returns (t, slot_tid, u, v,
    any_valid) for the best hit within the leaf, masked by ``count`` and
    ``t < t_best`` (strict, matching kdtree.cpp:255).
    """
    L = bvh.leaf_size
    slots = start[:, None] + jnp.arange(L, dtype=jnp.int32)[None, :]  # (R, L)
    valid_slot = jnp.arange(L, dtype=jnp.int32)[None, :] < count[:, None]
    slots = jnp.where(valid_slot, slots, 0)

    v0 = bvh.tri_v0[slots]          # (R, L, 3)
    e1 = bvh.tri_e1[slots]
    e2 = bvh.tri_e2[slots]

    d = dirs[:, None, :]
    p = jnp.cross(d, e2)
    a = _dot(e1, p)
    nonpar = jnp.abs(a) >= FLT_EPS
    f = 1.0 / jnp.where(nonpar, a, 1.0)
    s = origins[:, None, :] - v0
    u = f * _dot(s, p)
    q = jnp.cross(s, e1)
    v = f * _dot(d, q)
    t = f * _dot(e2, q)

    ok = (
        valid_slot
        & nonpar
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t >= 0.0)
        & (t < t_best[:, None])
    )
    t = jnp.where(ok, t, jnp.inf)
    best = jnp.argmin(t, axis=1)
    rows = jnp.arange(origins.shape[0])
    bt = t[rows, best]
    return (
        bt,
        bvh.tri_order[slots[rows, best]],
        u[rows, best],
        v[rows, best],
        jnp.isfinite(bt),
    )


def _box_hit(origins, inv_dirs, bmin, bmax, tmax):
    """Slab test against per-ray gathered boxes; hit iff [t0, t1] overlaps
    [0, tmax] (kdtree.cpp:196-216 semantics with running-tmax pruning)."""
    t0 = (bmin - origins) * inv_dirs
    t1 = (bmax - origins) * inv_dirs
    near = jnp.max(jnp.minimum(t0, t1), axis=-1)
    far = jnp.min(jnp.maximum(t0, t1), axis=-1)
    return (far >= near) & (far >= 0.0) & (near < tmax)


@partial(jax.jit, static_argnames=("max_iters",))
def bvh_closest(bvh: BVHArrays, origins, dirs, max_iters: int = 0):
    """Closest-hit for a ray wavefront. Returns ClosestHit arrays."""
    R = origins.shape[0]
    inv = 1.0 / dirs

    t_best = jnp.full((R,), jnp.inf)
    tid = jnp.zeros((R,), jnp.int32)
    uu = jnp.zeros((R,))
    vv = jnp.zeros((R,))
    node = jnp.zeros((R,), jnp.int32)

    limit = max_iters if max_iters > 0 else 4 * bvh.n_nodes + 8

    def cond(state):
        node, *_ , it = state
        return jnp.any(node != SENTINEL) & (it < limit)

    def body(state):
        node, t_best, tid, uu, vv, it = state
        active = node != SENTINEL
        ni = jnp.where(active, node, 0)

        bmin = bvh.bbox_min[ni]
        bmax = bvh.bbox_max[ni]
        hit_box = _box_hit(origins, inv, bmin, bmax, t_best) & active

        count = bvh.leaf_count[ni]
        is_leaf = (count > 0) & hit_box

        lt, ltid, lu, lv, lok = _leaf_intersect(
            bvh, origins, dirs, bvh.leaf_start[ni], jnp.where(is_leaf, count, 0),
            t_best,
        )
        better = lok & is_leaf
        t_best = jnp.where(better, lt, t_best)
        tid = jnp.where(better, ltid, tid)
        uu = jnp.where(better, lu, uu)
        vv = jnp.where(better, lv, vv)

        # Advance: internal box-hit -> i+1; leaf or miss -> miss_link.
        descend = hit_box & (count == 0)
        nxt = jnp.where(descend, ni + 1, bvh.miss_link[ni])
        node = jnp.where(active, nxt, node)
        return node, t_best, tid, uu, vv, it + 1

    node, t_best, tid, uu, vv, _ = jax.lax.while_loop(
        cond, body, (node, t_best, tid, uu, vv, jnp.int32(0))
    )
    hit = jnp.isfinite(t_best)
    return hit, t_best, tid, uu, vv


@partial(jax.jit, static_argnames=("max_iters",))
def bvh_any(bvh: BVHArrays, origins, dirs, tmax, exclude_id, max_iters: int = 0):
    """Any-hit (shadow) query: t in [0, tmax), excluding ``exclude_id``
    (kdtree.cpp:283-344).  Rays stop walking as soon as they find a hit."""
    R = origins.shape[0]
    inv = 1.0 / dirs
    L = bvh.leaf_size

    occluded = jnp.zeros((R,), bool)
    node = jnp.zeros((R,), jnp.int32)
    limit = max_iters if max_iters > 0 else 4 * bvh.n_nodes + 8

    def cond(state):
        node, _, it = state
        return jnp.any(node != SENTINEL) & (it < limit)

    def body(state):
        node, occluded, it = state
        active = (node != SENTINEL) & ~occluded
        ni = jnp.where(active, node, 0)

        hit_box = _box_hit(
            origins, inv, bvh.bbox_min[ni], bvh.bbox_max[ni], tmax
        ) & active
        count = bvh.leaf_count[ni]
        is_leaf = (count > 0) & hit_box

        start = bvh.leaf_start[ni]
        slots = start[:, None] + jnp.arange(L, dtype=jnp.int32)[None, :]
        valid_slot = (
            jnp.arange(L, dtype=jnp.int32)[None, :]
            < jnp.where(is_leaf, count, 0)[:, None]
        )
        slots = jnp.where(valid_slot, slots, 0)
        v0 = bvh.tri_v0[slots]
        e1 = bvh.tri_e1[slots]
        e2 = bvh.tri_e2[slots]
        d = dirs[:, None, :]
        p = jnp.cross(d, e2)
        a = _dot(e1, p)
        nonpar = jnp.abs(a) >= FLT_EPS
        f = 1.0 / jnp.where(nonpar, a, 1.0)
        s = origins[:, None, :] - v0
        u = f * _dot(s, p)
        q = jnp.cross(s, e1)
        v = f * _dot(d, q)
        t = f * _dot(e2, q)
        blocking = (
            valid_slot
            & nonpar
            & (u >= 0.0)
            & (u <= 1.0)
            & (v >= 0.0)
            & (u + v <= 1.0)
            & (t >= 0.0)
            & (t < tmax[:, None])
            & (bvh.tri_order[slots] != exclude_id[:, None])
        )
        occluded = occluded | jnp.any(blocking, axis=1)

        descend = hit_box & (count == 0)
        nxt = jnp.where(descend, ni + 1, bvh.miss_link[ni])
        node = jnp.where(node != SENTINEL, nxt, node)
        node = jnp.where(occluded, SENTINEL, node)
        return node, occluded, it + 1

    _, occluded, _ = jax.lax.while_loop(
        cond, body, (node, occluded, jnp.int32(0))
    )
    return occluded


def make_bvh_intersectors(
    scene: SceneArrays, bvh: BVHArrays
) -> Tuple[ClosestFn, AnyFn]:
    def closest_fn(origins, dirs) -> ClosestHit:
        hit, t, tid, u, v = bvh_closest(bvh, origins, dirs)
        return ClosestHit(hit, t, tid, u, v)

    def any_fn(origins, dirs, tmax, exclude_id):
        return bvh_any(bvh, origins, dirs, tmax, exclude_id)

    return closest_fn, any_fn
