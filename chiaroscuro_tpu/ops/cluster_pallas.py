"""Cluster (meshlet) intersector: XLA cull + per-row Triton visit kernel.

GPU replacement for per-ray kd-tree traversal on *large* scenes
(``src/kdtree.cpp:248-344``).  See ``accel/clusters.py`` for the meshlet
build; the division of labor is:

- **XLA cull pass** (:func:`_cull_rows`): exact per-lane AABB slab tests of
  all K cluster boxes, K-chunked so temporaries stay cache-sized, reduced
  to a per-row *candidate list* (ids of the boxes any ray of the row hits,
  ordered near-to-far) plus a trip count.  Rows that hit more than ``Le``
  boxes keep their ``Le`` nearest plus a ``cutoff`` (entry bound of the
  first excluded box); the kernel visits the prefix near-to-far and runs a
  residual full-K sweep only while some ray's result could still be beaten
  past the cutoff (:func:`_order_hits`), so the result is always exact.
- **Visit kernel** (Pallas, ``backend="triton"``): one program per row of
  ``ray_block`` rays.  The program loads its own list slice and walks it
  with a dynamic-trip loop that stops as soon as every ray's best ``t``
  undercuts the next box's entry distance.  Each visited cluster's
  triangles are loaded from global memory at a dynamic offset and tested
  a few at a time, as a (ray_block, SUB) register tile.

The kernel returns ``(t, tid, u, v)`` only.  Shading attributes are one
XLA gather by ``tid`` afterwards, so no matrix product (and no TF32
rounding) touches fetched values.

Cluster geometry lives in one **field-major matrix** ``geo`` of shape
(GEO_W, K*M): rows are v0|e1|e2 components and the original triangle id as
an exact float (which limits scenes to 2^24 triangles); columns are the
K clusters' M triangle slots.  A tile of a cluster is then GEO_W
contiguous loads of SUB floats.

Exactness vs the brute-force oracle (``geometry/intersect.py``): identical
epsilon and acceptance conditions; ties in t are broken to the lowest
*original* triangle id both within a cluster and across clusters, so
results match the oracle regardless of visit order.  Padded slots are
degenerate (det == 0) and never hit.

Differentiability: a custom VJP recomputes the continuous outputs
(t, u, v) for the winning triangle id from the *original-order* arrays —
the cull and the argmin are discrete and correctly excluded from
differentiation.  The attribute gather is plain JAX and differentiates
as a gather.

Without ``cull`` every row visits all K clusters in order, which turns the
same kernel into a dense sweep for small scenes.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from chiaroscuro_tpu.accel.clusters import ClusterArrays, build_clusters
from chiaroscuro_tpu.geometry.intersect import AnyFn, ClosestFn, ClosestHit
from chiaroscuro_tpu.scene.scene_arrays import SceneArrays

FLT_EPS = np.float32(np.finfo(np.float32).eps)
BIG = np.float32(3.0e38)
ID_SENTINEL = np.float32(1 << 24)   # > any real id; ids exact in f32 below it

# Field-major geometry rows: v0 (3) | e1 (3) | e2 (3) | original id (1).
GEO_W = 10

# Kernel shape, chosen on the H100 (CHANGES.md, PR 1): rays per program
# and per cull row, triangles per register tile, warps per program.
RAY_BLOCK = 32
SUB = 8
NUM_WARPS = 2
NUM_STAGES = 2

# Triangles per cluster, by scene size: up to SMALL_SCENE_TRIS triangles
# the cull (K boxes x rays) is cheap and small clusters keep each row's
# candidate list short; above it the cull's cost grows with K and larger
# clusters win.
SMALL_SCENE_TRIS = 1 << 16
SMALL_M, LARGE_M = 64, 128

# Candidate-list width.  A wide list is nearly free (the near-ordered walk
# exits early); a narrow one sends rows to the phase-2 residual sweep.
LMAX = 1536


def cluster_size(n_tris: int) -> int:
    """Triangles per cluster for a scene of ``n_tris`` triangles."""
    return SMALL_M if n_tris <= SMALL_SCENE_TRIS else LARGE_M

# Clamp for 1/dir in the slab test: keeps axis-parallel rays finite (no
# 0 * inf NaNs) while behaving like +-inf for containment purposes.
HUGE_INV = np.float32(1.0e30)

# Minimum cluster count for bounce compaction + spatial ray sorting
# (render/integrator.py) to be turned on for this intersector.
COMPACT_MIN_K = 1024

# Shading-attribute rows gathered per hit (integer fields ride as exact
# small floats).
ATTR_LAYOUT = {
    "v0": slice(0, 3),
    "e1": slice(3, 6),
    "e2": slice(6, 9),
    "normal": slice(9, 12),
    "kd": slice(12, 15),
    "ke": slice(15, 18),
    "uv0": slice(18, 20),
    "uv1": slice(20, 22),
    "uv2": slice(22, 24),
    "btype": slice(24, 25),
    "texid": slice(25, 26),
    "ks": slice(26, 29),
    "ns": slice(29, 30),
    "texid_ks": slice(30, 31),
}
ATTR_K = 32                 # 31 fields padded to a 128-byte row

_INT_ATTRS = ("btype", "texid", "texid_ks")


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------


def _attr_rows(scene, xp=jnp):
    """(T, ATTR_K) f32 shading-attribute rows, one per triangle.

    ``xp`` selects the array namespace: ``jnp`` when the scene fields are
    traced (differentiable rendering — gradients flow from the gathered
    attributes back into kd/ke/vertices); ``np`` for a concrete scene, so
    the result is a *host* constant (utils/hostconst.py).
    """
    T = scene.tri_v0.shape[0]
    cols = xp.concatenate(
        [
            scene.tri_v0,                                   # v0
            scene.tri_v1 - scene.tri_v0,                    # e1
            scene.tri_v2 - scene.tri_v0,                    # e2
            scene.normal,
            scene.kd,
            scene.ke,
            scene.uv0,
            scene.uv1,
            scene.uv2,
            scene.brdf_type[:, None].astype(np.float32),
            scene.tex_id[:, None].astype(np.float32),
            scene.ks,
            scene.shininess[:, None],
            scene.tex_id_ks[:, None].astype(np.float32),
        ],
        axis=1,
    )                                                       # (T, 31)
    return xp.concatenate(
        [cols, xp.zeros((T, ATTR_K - cols.shape[1]), np.float32)], axis=1
    )


def unpack_attrs_planar(mat):
    """(ATTR_K, B0, 128) gathered attributes -> dict of planar per-field
    arrays: vec3 as (3, B0, 128), uv pairs as (2, B0, 128), scalars as
    (B0, 128)."""
    out = {}
    for name, sl in ATTR_LAYOUT.items():
        col = mat[sl]
        if name in _INT_ATTRS:
            out[name] = jnp.round(col[0]).astype(jnp.int32)
        elif name == "ns":
            out[name] = col[0]
        else:
            out[name] = col
    return out


def _mt_core(o, d, v0, e1, e2):
    """Moller-Trumbore, pure elementwise over broadcastable components.

    o, d: tuples of ray-coordinate arrays; v0/e1/e2: tuples of
    triangle-coordinate arrays that broadcast against them.  Returns
    (ok, t, u, v) at the broadcast shape.
    """
    ox, oy, oz = o
    dx, dy, dz = d
    v0x, v0y, v0z = v0
    e1x, e1y, e1z = e1
    e2x, e2y, e2z = e2

    # p = cross(d, e2)
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    a = e1x * px + e1y * py + e1z * pz
    nonpar = jnp.abs(a) >= FLT_EPS
    f = 1.0 / jnp.where(nonpar, a, 1.0)

    sx = ox - v0x
    sy = oy - v0y
    sz = oz - v0z
    u = f * (sx * px + sy * py + sz * pz)
    # q = cross(s, e1)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)

    ok = (
        nonpar
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t >= 0.0)
    )
    return ok, t, u, v


def _rows_to_planar(rows):
    """(R, 3) -> ((3, B0, 128), R) padded to a 128 multiple with replicas
    of the first row (replicas cannot create degenerate configurations)."""
    R = rows.shape[0]
    pad = (-R) % 128
    if pad:
        rows = jnp.concatenate([rows, rows[:1].repeat(pad, 0)])
    return rows.T.reshape(3, -1, 128), R


# ---------------------------------------------------------------------------
# XLA cull pass
# ---------------------------------------------------------------------------


def _safe_inv(d3):
    """Per-axis clamped 1/d for the slab test (see HUGE_INV)."""
    inv = []
    for a in range(3):
        d = d3[a]
        mag = jnp.abs(d)
        capped = jnp.where(
            mag * HUGE_INV >= 1.0, 1.0 / jnp.where(mag > 0, d, 1.0), HUGE_INV
        )
        inv.append(jnp.where(d < 0, -jnp.abs(capped), jnp.abs(capped)))
    return inv


def _rowhit_scan(o3, inv, bmin, bmax, tmax=None, CK=32):
    """Per-row box hits and entry bounds, both (NR, K).

    o3/inv: (3, NR, RB) planar rays.  Exact per-ray slab tests, reduced
    over each row's RB rays.  The K axis streams in chunks through a
    ``lax.scan`` so the (CK, NR, RB) slab temporaries stay cache-sized.

    The entry bound is min over hitting rays of max(near, 0) — a lower
    bound on any intersection t inside box k for every ray of the row,
    used to order visits near-to-far and to exit early once every ray's
    best t undercuts the next box.
    """
    K = bmin.shape[0]
    Kp = -(-K // CK) * CK
    pad = Kp - K
    # Padding note: inverted boxes (min > max) do NOT test as misses here —
    # lo=min(t0,t1)/hi=max(t0,t1) undoes the inversion, so padded columns
    # test as the infinite box and DO register hits.  They are harmless only
    # because the result is sliced to [:, :K] below.
    bmn = np.concatenate([bmin, np.full((pad, 3), BIG)]) if pad else bmin
    bmx = np.concatenate([bmax, np.full((pad, 3), -BIG)]) if pad else bmax

    def chunk_hit(_, boxes):
        cmn, cmx = boxes                                   # (CK, 3) each
        near = None
        far = None
        for a in range(3):
            t0 = (cmn[:, a][:, None, None] - o3[a][None]) * inv[a][None]
            t1 = (cmx[:, a][:, None, None] - o3[a][None]) * inv[a][None]
            lo = jnp.minimum(t0, t1)
            hi = jnp.maximum(t0, t1)
            near = lo if near is None else jnp.maximum(near, lo)
            far = hi if far is None else jnp.minimum(far, hi)
        hit = (far >= near) & (far >= 0.0)                 # (CK, NR, RB)
        if tmax is not None:
            hit = hit & (near <= tmax[None])
        anyhit = jnp.any(hit, axis=2)                      # (CK, NR)
        entry = jnp.min(
            jnp.where(hit, jnp.maximum(near, 0.0), BIG), axis=2
        )
        return _, (anyhit, entry)

    _, (anyhit, entry) = jax.lax.scan(
        chunk_hit, 0,
        (jnp.asarray(bmn, jnp.float32).reshape(-1, CK, 3),
         jnp.asarray(bmx, jnp.float32).reshape(-1, CK, 3)),
    )
    return (
        anyhit.reshape(Kp, -1).T[:, :K],
        entry.reshape(Kp, -1).T[:, :K],
    )


def _order_hits(hits, entry, Le):
    """(NR, K) hit mask + entry distances -> near-ascending
    (meta, ids, nears, cutoff) lists of width Le.

    Visit order near-to-far is what lets the kernel exit early once every
    ray's best t undercuts the next box's entry (the analog of the
    reference kd-tree's split-plane-ordered descent,
    src/kdtree.cpp:248-281).

    Overflow rows (more than Le hits) get a **two-phase** contract: phase 1
    visits the Le *nearest* boxes near-to-far (trip = Le), and ``cutoff``
    — the entry distance of the first *excluded* box — tells the kernel
    whether the result is already exact (every ray's best t < cutoff: no
    excluded box can contain a closer hit, since a box's entry
    lower-bounds every intersection t inside it) or whether a residual
    identity-order sweep over all K boxes is needed (kernel phase 2;
    revisiting listed boxes is idempotent).  Non-overflow rows carry
    cutoff = +inf, which a miss sentinel (BIG) can never reach, so phase 2
    never triggers for them.
    """
    NR, K = hits.shape
    count = jnp.sum(hits, axis=1).astype(jnp.int32)
    key = jnp.where(hits, entry, BIG)
    cands = jnp.broadcast_to(jnp.arange(K, dtype=jnp.int32)[None], (NR, K))
    skey, sids = jax.lax.sort((key, cands), num_keys=1, is_stable=True)
    overflow = count > Le
    # Entry bound of the nearest box NOT in the list (real whenever
    # count > Le; unused otherwise).
    excl_entry = skey[:, Le] if K > Le else jnp.full((NR,), BIG, jnp.float32)
    trip = jnp.where(overflow, jnp.int32(Le), count)
    meta = jnp.stack([trip, overflow.astype(jnp.int32)], axis=1)
    cutoff = jnp.where(overflow, excl_entry, jnp.float32(np.inf))
    return meta, sids[:, :Le], skey[:, :Le], cutoff[:, None]


def _cull_rows(o3, d3, bmin, bmax, Lmax, tmax=None):
    """Per-row cluster culling (flat: linear sweep over all K boxes).

    o3, d3: (3, NR, RB) planar rays; bmin/bmax: (K, 3) boxes.  Returns
    (meta (NR, 2) i32 [trip, overflow], ids (NR, Le) i32 near-ascending,
    nears (NR, Le) f32 entry-distance bounds, cutoff (NR, 1) f32 phase-2
    trigger — see :func:`_order_hits`), Le = min(Lmax, K).

    Per-ray exactness matters: a conservative per-row interval variant is
    far cheaper but one divergent ray widens a bounce row's interval to
    the whole scene, and the inflated candidate lists cost the visit
    kernel more than the cull saves.
    """
    K = bmin.shape[0]
    o3 = jax.lax.stop_gradient(o3)
    d3 = jax.lax.stop_gradient(d3)
    tmax = None if tmax is None else jax.lax.stop_gradient(tmax)
    rowhit, entry = _rowhit_scan(o3, _safe_inv(d3), bmin, bmax, tmax)
    return _order_hits(rowhit, entry, min(Lmax, K))


# ---------------------------------------------------------------------------
# Triton visit kernels
# ---------------------------------------------------------------------------


def _tile(geo_ref, base, o, d, sub):
    """(RB, sub) Moller-Trumbore tile: packed slots [base, base + sub)
    against the row's rays (o, d: tuples of (RB, 1) columns)."""
    f = [geo_ref[k, pl.ds(base, sub)][None, :] for k in range(GEO_W)]
    ok, t, u, v = _mt_core(o, d, f[0:3], f[3:6], f[6:9])
    return ok, t, u, v, f[9]


def _closest_merge(carry, visit):
    best_t, best_id, best_u, best_v = carry
    tmin, idsel, cu, cv = visit
    better = (tmin < best_t) | (
        (tmin == best_t) & (idsel < best_id) & (tmin < BIG)
    )
    return (
        jnp.where(better, tmin, best_t),
        jnp.where(better, idsel, best_id),
        jnp.where(better, cu, best_u),
        jnp.where(better, cv, best_v),
    )


def _closest_cluster(carry, geo_ref, cid, o, d, M, sub):
    """Merge one cluster's best (t, original id, u, v) per ray into carry:
    the lexicographic-(t, id) minimum, tile by tile."""

    def tile(s, carry):
        ok, t, u, v, oid = _tile(geo_ref, cid * M + s * sub, o, d, sub)
        t = jnp.where(ok, t, BIG)
        tmin = jnp.min(t, axis=1)
        is_min = t == tmin[:, None]
        idsel = jnp.min(jnp.where(is_min, oid, ID_SENTINEL), axis=1)
        sel = is_min & (oid == idsel[:, None])              # one per ray
        cu = jnp.sum(jnp.where(sel, u, 0.0), axis=1)
        cv = jnp.sum(jnp.where(sel, v, 0.0), axis=1)
        return _closest_merge(carry, (tmin, idsel, cu, cv))

    return jax.lax.fori_loop(0, M // sub, tile, carry)


def _any_cluster(occ, geo_ref, cid, o, d, tmax, excl, M, sub):
    """OR one cluster's blockers (t < tmax, id != excl) into occ (f32 0/1)."""

    def tile(s, occ):
        ok, t, _, _, oid = _tile(geo_ref, cid * M + s * sub, o, d, sub)
        blocking = ok & (t < tmax[:, None]) & (oid != excl[:, None])
        return jnp.maximum(
            occ, jnp.max(jnp.where(blocking, 1.0, 0.0), axis=1)
        )

    return jax.lax.fori_loop(0, M // sub, tile, occ)


def _row_rays(o_ref, d_ref, r):
    o = tuple(o_ref[a, r, :][:, None] for a in range(3))     # (RB, 1)
    d = tuple(d_ref[a, r, :][:, None] for a in range(3))
    return o, d


def _closest_kernel(*refs, M, Le, NK, RB, cull, sub):
    if cull:
        meta_ref, ids_ref, nears_ref, cutoff_ref = refs[:4]
        refs = refs[4:]
    o_ref, d_ref, geo_ref, t_ref, id_ref, u_ref, v_ref = refs
    r = pl.program_id(0)
    o, d = _row_rays(o_ref, d_ref, r)
    init = (
        jnp.full((RB,), BIG, jnp.float32),
        jnp.full((RB,), ID_SENTINEL, jnp.float32),
        jnp.zeros((RB,), jnp.float32),
        jnp.zeros((RB,), jnp.float32),
    )

    def visit(c, cid):
        return _closest_cluster(c, geo_ref, cid, o, d, M, sub)

    if not cull:
        carry = jax.lax.fori_loop(0, NK, lambda j, c: visit(c, j), init)
    else:
        # Phase 1: the listed boxes near-to-far.  nears[j] lower-bounds
        # every ray's t inside box j, so once every ray's best t is below
        # it, no later box can improve any ray.
        trip = meta_ref[r, 0]
        cutoff = cutoff_ref[r, 0]

        def cond(state):
            j, c = state
            near = nears_ref[r, jnp.minimum(j, Le - 1)]
            return (j < trip) & (jnp.max(c[0]) >= near)

        def body(state):
            j, c = state
            return j + 1, visit(c, ids_ref[r, j])

        _, carry = jax.lax.while_loop(cond, body, (jnp.int32(0), init))

        # Phase 2 (overflow rows only): identity-order residual sweep while
        # some ray's best t could still be beaten by an unlisted box
        # (entry >= cutoff).  Non-overflow rows carry cutoff = +inf.
        def cond2(state):
            j, c = state
            return (j < NK) & (jnp.max(c[0]) >= cutoff)

        def body2(state):
            j, c = state
            return j + 1, visit(c, j)

        _, carry = jax.lax.while_loop(cond2, body2, (jnp.int32(0), carry))

    bt, bi, bu, bv = carry
    t_ref[r, :] = bt
    id_ref[r, :] = jnp.where(bt < BIG, bi, 0.0).astype(jnp.int32)
    u_ref[r, :] = bu
    v_ref[r, :] = bv


def _any_kernel(*refs, M, Le, NK, RB, cull, sub):
    if cull:
        meta_ref, ids_ref, nears_ref, cutoff_ref = refs[:4]
        refs = refs[4:]
    o_ref, d_ref, tmax_ref, excl_ref, geo_ref, occ_ref = refs
    r = pl.program_id(0)
    o, d = _row_rays(o_ref, d_ref, r)
    tmax = tmax_ref[r, :]
    excl = excl_ref[r, :]

    def visit(occ, cid):
        return _any_cluster(occ, geo_ref, cid, o, d, tmax, excl, M, sub)

    def open_tmax(occ):
        return jnp.max(jnp.where(occ < 1.0, tmax, -BIG))

    init = jnp.zeros((RB,), jnp.float32)
    if not cull:
        occ = jax.lax.fori_loop(0, NK, lambda j, c: visit(c, j), init)
    else:
        trip = meta_ref[r, 0]
        cutoff = cutoff_ref[r, 0]

        # Exits when every ray is occluded, or when the next box's entry
        # exceeds every unoccluded ray's tmax (boxes are near-ascending).
        def cond(state):
            j, occ = state
            near = nears_ref[r, jnp.minimum(j, Le - 1)]
            return (j < trip) & (jnp.min(occ) < 1.0) & (near <= open_tmax(occ))

        def body(state):
            j, occ = state
            return j + 1, visit(occ, ids_ref[r, j])

        _, occ = jax.lax.while_loop(cond, body, (jnp.int32(0), init))

        # Phase 2 (overflow rows): unlisted boxes all have entry >= cutoff.
        def cond2(state):
            j, occ = state
            return (j < NK) & (jnp.min(occ) < 1.0) & (cutoff <= open_tmax(occ))

        def body2(state):
            j, occ = state
            return j + 1, visit(occ, j)

        _, occ = jax.lax.while_loop(cond2, body2, (jnp.int32(0), occ))

    occ_ref[r, :] = occ


@partial(jax.jit, static_argnames=("M", "Le", "sub", "warps", "interpret"))
def _closest_call(lists, o3, d3, geo, M, Le, sub, warps, interpret=False):
    """lists: (meta, ids, nears, cutoff) from the cull, or () for a dense
    sweep over every cluster.  o3/d3: (3, NR, RB).  ``sub`` triangles per
    register tile, ``warps`` warps per program."""
    NR, RB = o3.shape[1:]
    NK = geo.shape[1] // M
    row = jax.ShapeDtypeStruct((NR, RB), jnp.float32)
    return pl.pallas_call(
        partial(_closest_kernel, M=M, Le=Le, NK=NK, RB=RB,
                cull=bool(lists), sub=sub),
        grid=(NR,),
        out_shape=[row, jax.ShapeDtypeStruct((NR, RB), jnp.int32), row, row],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=warps,
                                           num_stages=NUM_STAGES),
        interpret=interpret,
        name="cluster_closest",
    )(*lists, o3, d3, geo)


@partial(jax.jit, static_argnames=("M", "Le", "sub", "warps", "interpret"))
def _any_call(lists, o3, d3, tmax, excl, geo, M, Le, sub, warps,
              interpret=False):
    NR, RB = o3.shape[1:]
    NK = geo.shape[1] // M
    return pl.pallas_call(
        partial(_any_kernel, M=M, Le=Le, NK=NK, RB=RB, cull=bool(lists),
                sub=sub),
        grid=(NR,),
        out_shape=jax.ShapeDtypeStruct((NR, RB), jnp.float32),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=warps,
                                           num_stages=NUM_STAGES),
        interpret=interpret,
        name="cluster_any",
    )(*lists, o3, d3, tmax, excl, geo)


# ---------------------------------------------------------------------------
# Public interface
# ---------------------------------------------------------------------------


def make_cluster_intersectors(
    scene: SceneArrays,
    M: int | None = None,
    Lmax: int = LMAX,
    interpret: bool = False,
    clusters: ClusterArrays | None = None,
    ray_block: int | None = None,
    cull: bool = True,
) -> Tuple[ClosestFn, AnyFn]:
    """Cluster-culled Triton intersectors.

    The meshlet decomposition (permutation + boxes) is built host-side from
    the scene's *concrete* geometry; rebuild the intersectors if vertex
    positions change materially (box padding absorbs <= 1e-4 drift).  The
    kernel's geometry matrix is derived from the (possibly traced) scene
    arrays with in-graph gathers, so gradients flow to kd/ke/uv/vertices
    exactly as on the brute-force path.

    ``ray_block`` rays share one candidate list and one kernel program
    (a power of two dividing 128; default ``RAY_BLOCK``); ``M`` is the
    cluster size (a multiple of ``SUB`` or a power of two below it;
    default :func:`cluster_size` of the scene, capped at the scene's own
    size).  ``cull=False`` skips the cull and visits every cluster: the
    dense sweep.  The kernel compiles for the GPU only; ``interpret``
    runs it in the Pallas interpreter (tests on CPU).

    The returned functions carry a ``bind_scene(scene)`` attribute: it
    re-derives the buffers from the *given* scene pytree and returns
    planar (closest, any) functions bound to them.  The integrator calls it
    with its (usually traced) scene argument so the buffers become values
    computed from jit arguments instead of large constants, derived once
    per frame outside the sample/bounce scans.  For many frames of an
    UNCHANGING scene, ``derive_buffers`` + ``bind_buffers`` pass the
    buffers as jit arguments instead (see their docstrings).
    """
    if not interpret and jax.default_backend() != "gpu":
        raise ValueError(
            "the cluster intersector's kernel compiles for the GPU only; "
            f"this process runs on {jax.default_backend()!r}. Pass "
            "interpret=True to run it in the Pallas interpreter."
        )
    T = scene.tri_v0.shape[0]
    if T >= int(ID_SENTINEL):
        raise ValueError("cluster intersector supports < 2^24 triangles")
    ray_block = ray_block or RAY_BLOCK
    if 128 % ray_block or ray_block & (ray_block - 1):
        raise ValueError(f"ray_block must be a power of two dividing 128, "
                         f"got {ray_block}")
    if clusters is None:
        if M is None:
            M = min(cluster_size(T), -(-T // SUB) * SUB)
        clusters = build_clusters(
            np.asarray(scene.tri_v0),
            np.asarray(scene.tri_v1),
            np.asarray(scene.tri_v2),
            M,
        )
    M = clusters.M
    K = clusters.K
    sub, warps = min(SUB, M), NUM_WARPS
    if M % sub or sub & (sub - 1):
        raise ValueError(f"cluster size M={M} must be a multiple of {SUB} "
                         "or a power of two below it")
    Le = min(Lmax, K)
    # Host (numpy) constants: captured by jitted callers without a
    # device->host fetch at lowering time (utils/hostconst.py).
    bmin = np.asarray(clusters.bbox_min)
    bmax = np.asarray(clusters.bbox_max)
    cull_fn = partial(_cull_rows, bmin=bmin, bmax=bmax, Lmax=Le)
    oid = np.asarray(clusters.orig_id)                     # (K*M,) i32
    safe_oid = np.minimum(oid, T - 1)
    real = oid < T
    oid_f = np.where(real, oid.astype(np.float32), ID_SENTINEL)

    def _derive(scene, xp):
        """(tri_orig, attr_rows, geo); ``xp=jnp`` keeps them in-graph
        (differentiable w.r.t. scene fields), ``xp=np`` builds host
        constants once."""
        tri_orig = xp.concatenate(
            [
                scene.tri_v0,
                scene.tri_v1 - scene.tri_v0,
                scene.tri_v2 - scene.tri_v0,
            ],
            axis=1,
        )                                                  # (T, 9)
        tri_perm = xp.where(real[:, None], tri_orig[safe_oid], 0.0)
        geo = xp.concatenate(
            [tri_perm, oid_f[:, None]], axis=1             # (K*M, GEO_W)
        ).T
        return (
            tri_orig.astype(np.float32),
            _attr_rows(scene, xp).astype(np.float32),
            geo.astype(np.float32),
        )

    from chiaroscuro_tpu.utils.hostconst import host_tree, is_traced

    def derive(s):
        """Buffers for a scene: in-graph (traced, differentiable) when
        ``s`` is traced, host numpy constants otherwise."""
        if is_traced(s):
            return _derive(s, xp=jnp)
        return _derive(host_tree(s), xp=np)

    def _blocks(x):
        """(3, B0, 128) or (B0, 128) -> rows of ray_block rays."""
        return x.reshape(x.shape[:-2] + (-1, ray_block))

    def _closest_impl(o3, d3, geo):
        B = o3.shape[1:]
        o3b, d3b = _blocks(o3), _blocks(d3)
        lists = cull_fn(o3b, d3b) if cull else ()
        out = _closest_call(lists, o3b, d3b, geo, M, Le, sub, warps,
                            interpret=interpret)
        return tuple(x.reshape(B) for x in out)

    # custom_vjp over *derived arrays*, not the SceneArrays pytree: carrying
    # the full pytree through the residuals breaks lowering when the call
    # sits inside a lax.scan under jit(grad).  The gradient path is the
    # recompute from the original-order arrays, so the packed matrix gets
    # a zero cotangent by construction.
    @jax.custom_vjp
    def closest(o3, d3, tri_orig, geo):
        return _closest_impl(o3, d3, geo)

    def _closest_fwd(o3, d3, tri_orig, geo):
        out = _closest_impl(o3, d3, geo)
        t, tid, u, v = out
        return out, (o3, d3, tri_orig, tid, t < BIG)

    def _closest_bwd(res, cts):
        o3, d3, tri_orig, tid, hitm = res
        ct_t, _ct_tid, ct_u, ct_v = cts
        h = hitm.astype(jnp.float32)

        def recompute(o3, d3, tri_orig):
            tri = tri_orig.T[:, tid]                       # (9, B0, 128)
            _, t, u, v = _mt_core(
                (o3[0], o3[1], o3[2]),
                (d3[0], d3[1], d3[2]),
                (tri[0], tri[1], tri[2]),
                (tri[3], tri[4], tri[5]),
                (tri[6], tri[7], tri[8]),
            )
            return t, u, v

        _, vjp = jax.vjp(recompute, o3, d3, tri_orig)
        g_o3, g_d3, g_tri = vjp((ct_t * h, ct_u * h, ct_v * h))
        return g_o3, g_d3, g_tri, jnp.zeros((GEO_W, K * M), jnp.float32)

    closest.defvjp(_closest_fwd, _closest_bwd)

    def _make_planar_fns(tri_orig, attr_rows, geo):
        def closest_planar(o3, d3) -> ClosestHit:
            t, tid, u, v = closest(o3, d3, tri_orig, geo)
            am = jnp.moveaxis(jnp.take(attr_rows, tid, axis=0), -1, 0)
            return ClosestHit(t < BIG, t, tid, u, v, unpack_attrs_planar(am))

        geo_sg = jax.lax.stop_gradient(geo)

        def any_planar(o3, d3, tmax, excl):
            B = o3.shape[1:]
            o3b = _blocks(jax.lax.stop_gradient(o3))
            d3b = _blocks(jax.lax.stop_gradient(d3))
            tmaxb = _blocks(jax.lax.stop_gradient(tmax))
            # ids compared as exact floats in-kernel
            exclb = _blocks(excl.astype(jnp.float32))
            lists = cull_fn(o3b, d3b, tmax=tmaxb) if cull else ()
            occ = _any_call(lists, o3b, d3b, tmaxb, exclb, geo_sg, M, Le,
                            sub, warps, interpret=interpret)
            return occ.reshape(B) > 0.0

        return closest_planar, any_planar

    def _flat(x, R):
        return x.reshape(-1)[:R]

    def _finalize(closest_planar, any_planar):
        def closest_fn(origins, dirs) -> ClosestHit:
            o3, R = _rows_to_planar(origins)
            d3, _ = _rows_to_planar(dirs)
            res = closest_planar(o3, d3)
            attrs = {}
            for k, pv in res.attrs.items():
                if pv.ndim == 3:
                    attrs[k] = pv.reshape(pv.shape[0], -1).T[:R]
                else:
                    attrs[k] = _flat(pv, R)
            return ClosestHit(
                _flat(res.hit, R), _flat(res.t, R), _flat(res.tid, R),
                _flat(res.u, R), _flat(res.v, R), attrs,
            )

        def any_fn(origins, dirs, tmax, exclude_id):
            o3, R = _rows_to_planar(origins)
            d3, _ = _rows_to_planar(dirs)
            pad = (-R) % 128
            if pad:
                tmax = jnp.concatenate([tmax, tmax[:1].repeat(pad, 0)])
                exclude_id = jnp.concatenate(
                    [exclude_id, exclude_id[:1].repeat(pad, 0)]
                )
            occ = any_planar(
                o3, d3, tmax.reshape(-1, 128), exclude_id.reshape(-1, 128)
            )
            return _flat(occ, R)

        closest_fn.planar_fn = closest_planar
        any_fn.planar_fn = any_planar
        closest_fn.bind_scene = bind_scene
        any_fn.bind_scene = bind_scene
        closest_fn.derive_buffers = derive_buffers
        any_fn.derive_buffers = derive_buffers
        closest_fn.bind_buffers = bind_buffers
        any_fn.bind_buffers = bind_buffers
        # Bounce compaction + spatial ray sorting keep the cull's per-row
        # candidate lists short; they pay for their per-bounce sorts only
        # when K is large.  The renderer reads these preferences.
        closest_fn.prefers_compaction = cull and K >= COMPACT_MIN_K
        closest_fn.prefers_ray_sort = cull and K >= COMPACT_MIN_K
        return closest_fn, any_fn

    def bind_scene(s):
        """Intersector pair bound to buffers derived from ``s`` — traced,
        differentiable derivation when ``s`` is traced (see docstring).
        ``render_samples`` calls this with its scene argument once per
        frame, outside the sample/bounce scans."""
        return _finalize(*_make_planar_fns(*derive(s)))

    def derive_buffers(s):
        """(tri_orig, attr_rows, geo) derived ONCE from a concrete scene,
        device-resident — for callers that render many frames of an
        unchanging scene and pass the buffers as jit *arguments* via
        :func:`bind_buffers`.  NOT for differentiable paths (stale buffers
        under parameter updates); use bind_scene with the traced scene
        there."""
        return tuple(jax.device_put(b) for b in derive(s))

    def bind_buffers(bufs):
        """Intersector pair bound to precomputed (possibly traced-argument)
        buffers from :func:`derive_buffers`.  The returned functions carry
        ``bind_scene = None`` so render_samples does NOT re-derive."""
        cf, af = _finalize(*_make_planar_fns(*bufs))
        cf.bind_scene = None
        af.bind_scene = None
        return cf, af

    return bind_scene(scene)
