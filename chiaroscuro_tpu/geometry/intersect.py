"""Batched ray-triangle intersection (Moller-Trumbore) and AABB slab tests.

The brute-force closest-hit/any-hit intersectors here are the *oracle* for
every acceleration structure in ``accel/`` and ``ops/`` (SURVEY.md §7 stage 3):
they test every (ray, triangle) pair with a masked reduction.  The math is the
reference's Moller-Trumbore variant (``src/kdtree.cpp:219-246``), including
its epsilon and acceptance conditions:

    |a| < float32_eps           -> miss   (parallel ray)
    u in [0, 1], v >= 0, u+v <= 1
    t >= 0                      -> hit at distance t (in units of |dir|)

Triangles are streamed in fixed-size chunks with ``lax.scan`` so peak memory
is O(rays * chunk) rather than O(rays * tris); XLA fuses the per-chunk
elementwise work and keeps the running best in registers.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

FLT_EPS = np.float32(np.finfo(np.float32).eps)
INF = np.float32(np.inf)


class ClosestHit(NamedTuple):
    """Result of a closest-hit query over a ray wavefront.

    ``attrs`` optionally carries per-hit shading attributes fetched *by the
    intersector itself* — the cluster kernel's caller gathers one packed
    attribute row per hit.  ``None`` means the integrator gathers from
    SceneArrays by ``tid`` instead.  Layout when present: dict of arrays,
    keys 'v0','e1','e2','normal','kd','ke','uv0'..'uv2','btype','texid',
    'ks','ns','texid_ks' (see ops/cluster_pallas.ATTR_LAYOUT).
    """

    hit: jax.Array   # (R,) bool
    t: jax.Array     # (R,) f32 distance in units of |dir|
    tid: jax.Array   # (R,) int32 triangle id
    u: jax.Array     # (R,) f32 barycentric weight of v1
    v: jax.Array     # (R,) f32 barycentric weight of v2
    attrs: object = None  # Optional[dict[str, jax.Array]]


# closest_fn(origins, dirs) -> ClosestHit
ClosestFn = Callable[[jax.Array, jax.Array], ClosestHit]
# any_fn(origins, dirs, tmax, exclude_id) -> occluded (R,) bool
AnyFn = Callable[[jax.Array, jax.Array, jax.Array, jax.Array], jax.Array]


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def moller_trumbore(origins, dirs, v0, v1, v2):
    """All-pairs Moller-Trumbore.

    origins, dirs: (R, 3); v0, v1, v2: (T, 3).
    Returns (valid, t, u, v), each (R, T).
    """
    e1 = v1 - v0                    # (T, 3)
    e2 = v2 - v0                    # (T, 3)

    d = dirs[:, None, :]            # (R, 1, 3)
    p = jnp.cross(d, e2[None, :, :])            # (R, T, 3)
    a = _dot(e1[None, :, :], p)                 # (R, T)

    nonparallel = jnp.abs(a) >= FLT_EPS
    f = 1.0 / jnp.where(nonparallel, a, 1.0)

    s = origins[:, None, :] - v0[None, :, :]    # (R, T, 3)
    u = f * _dot(s, p)
    q = jnp.cross(s, e1[None, :, :])            # (R, T, 3)
    v = f * _dot(d, q)
    t = f * _dot(e2[None, :, :], q)

    valid = (
        nonparallel
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t >= 0.0)
    )
    return valid, t, u, v


def _pad_tris(v0, v1, v2, chunk):
    """Pad triangle arrays to a multiple of ``chunk`` with degenerate
    triangles (all-zero -> a == 0 -> never hit)."""
    n = v0.shape[0]
    n_pad = (-n) % chunk
    if n_pad:
        z = jnp.zeros((n_pad, 3), v0.dtype)
        v0 = jnp.concatenate([v0, z])
        v1 = jnp.concatenate([v1, z])
        v2 = jnp.concatenate([v2, z])
    return v0, v1, v2, n + n_pad


def intersect_closest_bruteforce(origins, dirs, v0, v1, v2, chunk: int = 2048):
    """Closest-hit over all triangles.

    Returns (hit, t, tri_id, u, v) with shapes (R,).  Ties in t resolve to the
    lowest triangle id, matching the reference's in-order leaf sweep with a
    strict ``dist < tmax`` update (``kdtree.cpp:253-261``).
    """
    R = origins.shape[0]
    n_tris = v0.shape[0]
    chunk = int(min(chunk, max(n_tris, 1)))
    v0p, v1p, v2p, n_padded = _pad_tris(v0, v1, v2, chunk)
    n_chunks = n_padded // chunk

    tv0 = v0p.reshape(n_chunks, chunk, 3)
    tv1 = v1p.reshape(n_chunks, chunk, 3)
    tv2 = v2p.reshape(n_chunks, chunk, 3)

    def body(carry, tris):
        best_t, best_id, best_u, best_v, base = carry
        cv0, cv1, cv2 = tris
        valid, t, u, v = moller_trumbore(origins, dirs, cv0, cv1, cv2)
        t = jnp.where(valid, t, INF)
        local = jnp.argmin(t, axis=1)                      # (R,) first-min
        rows = jnp.arange(R)
        ct, cu, cv_ = t[rows, local], u[rows, local], v[rows, local]
        better = ct < best_t
        best_t = jnp.where(better, ct, best_t)
        best_id = jnp.where(better, base + local, best_id)
        best_u = jnp.where(better, cu, best_u)
        best_v = jnp.where(better, cv_, best_v)
        return (best_t, best_id, best_u, best_v, base + chunk), None

    init = (
        jnp.full((R,), INF),
        jnp.zeros((R,), jnp.int32),
        jnp.zeros((R,)),
        jnp.zeros((R,)),
        jnp.int32(0),
    )
    (best_t, best_id, best_u, best_v, _), _ = jax.lax.scan(
        body, init, (tv0, tv1, tv2)
    )
    hit = jnp.isfinite(best_t)
    return hit, best_t, best_id, best_u, best_v


def intersect_any_bruteforce(
    origins, dirs, v0, v1, v2, tmax, exclude_id, chunk: int = 2048
):
    """Any-hit (shadow) query: does any triangle with id != exclude_id block
    the ray at t in [0, tmax)?  (``kdtree.cpp:283-344``.)

    origins, dirs: (R, 3); tmax, exclude_id: (R,).  Returns occluded (R,).
    """
    n_tris = v0.shape[0]
    chunk = int(min(chunk, max(n_tris, 1)))
    v0p, v1p, v2p, n_padded = _pad_tris(v0, v1, v2, chunk)
    n_chunks = n_padded // chunk

    tv0 = v0p.reshape(n_chunks, chunk, 3)
    tv1 = v1p.reshape(n_chunks, chunk, 3)
    tv2 = v2p.reshape(n_chunks, chunk, 3)

    def body(carry, tris):
        occluded, base = carry
        cv0, cv1, cv2 = tris
        valid, t, _, _ = moller_trumbore(origins, dirs, cv0, cv1, cv2)
        ids = base + jnp.arange(chunk, dtype=jnp.int32)[None, :]
        blocking = valid & (t < tmax[:, None]) & (ids != exclude_id[:, None])
        return (occluded | jnp.any(blocking, axis=1), base + chunk), None

    (occluded, _), _ = jax.lax.scan(
        body, (jnp.zeros(origins.shape[0], bool), jnp.int32(0)), (tv0, tv1, tv2)
    )
    return occluded


def intersect_aabb(origins, dirs, box_min, box_max):
    """Slab test (``kdtree.cpp:196-208``). Returns (tmin, tmax) per ray;
    the ray intersects the box iff tmax >= max(tmin, 0)... the reference's
    caller checks ``tmax >= 0 and tmax >= tmin`` (``kdtree.cpp:213``)."""
    inv = 1.0 / dirs                                     # IEEE inf on 0 is fine
    t0 = (box_min[None, :] - origins) * inv              # (R, 3)
    t1 = (box_max[None, :] - origins) * inv
    tmin = jnp.max(jnp.minimum(t0, t1), axis=-1)
    tmax = jnp.min(jnp.maximum(t0, t1), axis=-1)
    return tmin, tmax
