"""Wavefront path-tracing integrator.

The reference integrates with per-pixel recursion + Russian-roulette early
``return`` (``src/rayTracer.cpp:76-135``).  Under ``jit``, data-dependent
recursion does not exist; instead we run a **wavefront**: all rays advance
through a ``lax.scan`` over bounce index with an active mask, and terminated
lanes simply stop contributing.  The estimator is mathematically identical —
NEE + cosine-BSDF sampling + RR become masked updates of (throughput, L).

Reference semantics preserved exactly (required for allclose parity):
- emission only on *primary* hits, weighted by max(0, dot(wo, n))
  (``rayTracer.cpp:85``) — secondary light hits contribute only via NEE;
- NEE geometric term max(0, cos_i * cos_l) / (1 + d^2) — the reference's
  nonstandard falloff (``rayTracer.cpp:106``);
- NEE weight = area * n_lights (uniform light pick, pdf 1/n_lights;
  ``rayTracer.cpp:108``), light point from v0 ~ U(0,1), v1 ~ U(0, 1-v0)
  (``rayTracer.cpp:96-97`` — *not* uniform over the triangle; preserved);
- shadow ray from hit + 1e-3 * n with tmax = distance, excluding the sampled
  light triangle id (``rayTracer.cpp:104``, ``kdtree.cpp:322-331``);
- Russian roulette on Kmax = max(f.rgb) = max(Kd)/pi, survival iff
  u <= Kmax, throughput *= f * |cos| / (pdf * Kmax) (``rayTracer.cpp:124-131``);
- depth cap k == K stops after direct lighting (``rayTracer.cpp:113-116``);
- miss at any depth contributes throughput * background
  (``rayTracer.cpp:134``);
- flat per-triangle normal = mean of vertex normals, used raw
  (``kdtree.cpp:58-60``), hit point from barycentric interpolation
  (``rayTracer.cpp:150-151``).

Intersectors are injected (``closest_fn``, ``any_fn``) so the same integrator
drives the brute-force oracle, the BVH traversal, and the cluster kernel.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from chiaroscuro_tpu.geometry import planar as P
from chiaroscuro_tpu.geometry.intersect import AnyFn, ClosestFn, ClosestHit  # noqa: F401
from chiaroscuro_tpu.sampling import prng
from chiaroscuro_tpu.sampling.samplers import (
    M_1_PI,
    phong_pdf_planar,
    reflect_planar,
    sample_phong_lobe_planar,
    sample_wi_diffuse_planar,
)
from chiaroscuro_tpu.scene.scene_arrays import (
    BRDF_EMISSIVE,
    BRDF_PHONG,
    SceneArrays,
)

EPS_OFFSET = np.float32(1.0e-3)  # rayTracer.cpp:104,130

# Bounce-compaction segment width in lanes (see trace_paths_planar): live
# lanes pack to the front of each segment between bounces.
COMPACT_SEG_LANES = 4096

# Per-axis |direction|-share bits in the spatial bounce-sort key: 2 -> 4x4
# angular bins inside each octant.  Ordering-only metadata — any value is
# correct; it must stay below 7, where the 32-bit key would overflow.
_DIR_BITS = 2


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def _normalize(v):
    n = jnp.linalg.norm(v, axis=-1, keepdims=True)
    return v / jnp.where(n == 0.0, 1.0, n)


def _interp_uv(scene: SceneArrays, tid, u, v):
    w = 1.0 - u - v
    return (
        scene.uv0[tid] * w[..., None]
        + scene.uv1[tid] * u[..., None]
        + scene.uv2[tid] * v[..., None]
    )


def _atlas_fetch(scene: SceneArrays, tex_id, uv, fallback):
    """Nearest-texel fetch with repeat wrap from the flat atlas, or
    ``fallback`` where ``tex_id < 0``.

    Wrap semantics mirror the reference's while-loop wrap (``mesh.cpp:21-35``):
    fractional part, except exactly-integral coords > 0 map to 1.0 (then
    clamped to the last texel — the reference reads out of bounds there; we
    clamp, a conscious divergence documented in SURVEY.md §7).
    """
    if scene.tex_data.shape[0] <= 1:
        # Untextured scene (the atlas holds only the dummy texel): the fetch
        # is statically a no-op — skip the gathers entirely.
        return fallback
    safe_id = jnp.maximum(tex_id, 0)
    tw = scene.tex_width[safe_id]
    th = scene.tex_height[safe_id]
    off = scene.tex_offset[safe_id]

    def wrap(c):
        f = c - jnp.floor(c)
        return jnp.where((f == 0.0) & (c > 0.0), 1.0, f)

    x = jnp.minimum((wrap(uv[..., 0]) * tw).astype(jnp.int32), tw - 1)
    y = jnp.minimum((wrap(uv[..., 1]) * th).astype(jnp.int32), th - 1)
    texel = scene.tex_data[off + y * tw + x]
    return jnp.where((tex_id >= 0)[..., None], texel, fallback)


def texture_kd_lookup(scene: SceneArrays, tid, u, v):
    """Diffuse albedo at a hit (``rayTracer.cpp:153-157``)."""
    return _atlas_fetch(
        scene, scene.tex_id[tid], _interp_uv(scene, tid, u, v), scene.kd[tid]
    )


def texture_ks_lookup(scene: SceneArrays, tid, u, v):
    """Specular reflectance at a hit (Phong extension; the reference loads
    specular maps but uses them only in its raster preview, ``mesh.cpp:54-62``)."""
    return _atlas_fetch(
        scene, scene.tex_id_ks[tid], _interp_uv(scene, tid, u, v), scene.ks[tid]
    )


def _atlas_fetch_planar(scene: SceneArrays, tex_id, uvp, fallback):
    """Planar-layout :func:`_atlas_fetch`: tex_id (B0, 128), uvp (2, B0, 128),
    fallback (3, B0, 128).  Texels gathered from the transposed atlas so the
    result lands planar without a relayout."""
    if scene.tex_data.shape[0] <= 1:
        return fallback
    safe_id = jnp.maximum(tex_id, 0)
    tw = scene.tex_width[safe_id]
    th = scene.tex_height[safe_id]
    off = scene.tex_offset[safe_id]

    def wrap(c):
        f = c - jnp.floor(c)
        return jnp.where((f == 0.0) & (c > 0.0), 1.0, f)

    x = jnp.minimum((wrap(uvp[0]) * tw).astype(jnp.int32), tw - 1)
    y = jnp.minimum((wrap(uvp[1]) * th).astype(jnp.int32), th - 1)
    texel = scene.tex_data.T[:, off + y * tw + x]     # (3, B0, 128)
    return jnp.where((tex_id >= 0)[None], texel, fallback)


def trace_paths(
    scene: SceneArrays,
    origins: jax.Array,       # (R, 3) ray origins (camera eye, broadcast)
    dirs: jax.Array,          # (R, 3) primary directions (may be unnormalized)
    keys: jax.Array,          # (R, 2) per-(pixel,sample) u32 PRNG keys
    depth: int,               # scene.k — max path vertices
    background: jax.Array,    # (3,)
    closest_fn: ClosestFn,
    any_fn: AnyFn,
) -> jax.Array:
    """Estimate radiance for R primary rays (row-major convenience wrapper
    around :func:`trace_paths_planar`).  Returns (R, 3)."""
    R = origins.shape[0]
    pad = (-R) % 128
    if pad:
        # Pad with replicas of ray 0: results are sliced off, and replicas
        # cannot introduce degenerate configurations (NaN grads) that the
        # real rays don't already have.
        origins = jnp.concatenate([origins, origins[:1].repeat(pad, 0)])
        dirs = jnp.concatenate([dirs, dirs[:1].repeat(pad, 0)])
        keys = jnp.concatenate([keys, keys[:1].repeat(pad, 0)])
    B = ((R + pad) // 128, 128)
    radiance = trace_paths_planar(
        scene,
        P.to_planar(origins, B),
        P.to_planar(dirs, B),
        keys[:, 0].reshape(B),
        keys[:, 1].reshape(B),
        depth,
        background,
        closest_fn,
        any_fn,
    )
    return P.to_rows(radiance)[:R]


def trace_paths_planar(
    scene: SceneArrays,
    origins: jax.Array,       # (3, B0, 128) planar ray origins
    dirs: jax.Array,          # (3, B0, 128) planar primary directions
    k0: jax.Array,            # (B0, 128) u32 per-(pixel,sample) key word 0
    k1: jax.Array,            # (B0, 128) u32 key word 1
    depth: int,               # scene.k — max path vertices
    background: jax.Array,    # (3,)
    closest_fn: ClosestFn,
    any_fn: AnyFn,
    with_stats: bool = False,
    compact: bool = False,
) -> jax.Array:
    """Estimate radiance for a planar wavefront. Returns (3, B0, 128).

    With ``with_stats=True`` returns ``(radiance, stats)`` where stats is a
    (depth, 2) f32 array of per-bounce useful-work counts:
    ``stats[k] = (lanes active at bounce entry, lanes that hit)`` — i.e. the
    closest-hit and shadow queries whose results are actually consumed.  The
    wavefront *issues* full-width queries regardless (masked lanes ride
    along); the ratio stats/issued is the SIMD occupancy of the wavefront.

    All per-ray state is kept **2-D over the ray axis** — scalars as
    (B0, 128), vec3 as planar (3, B0, 128) (see geometry/planar.py).
    Planar-native intersectors (``.planar_fn``) are called with zero
    relayouts; row-major ones get explicit conversions at the call
    boundary.

    ``compact=True`` enables **bounce-ray compaction** (the wavefront
    equivalent of the reference's recursion simply returning,
    ``rayTracer.cpp:124-131``): at each bounce entry, live lanes are
    stable-sorted to the front of their COMPACT_SEG_LANES-lane segment and
    dead lanes to its tail, so whole rows of dead rays become contiguous
    and cost trip=0 in the cluster cull.  All per-lane state (keys, throughput,
    accumulated radiance, the lane -> original-pixel permutation) moves
    with the sort's permutation in one stacked gather; radiance is sorted
    back to pixel order at the end.
    Every per-lane float op is unchanged, reductions are permutation-safe
    (exact-integer stats sums, order-free intersection argmins), so radiance
    is **bitwise identical** to ``compact=False`` — pinned by
    tests/test_integrator.py.

    When the intersector declares ``prefers_ray_sort`` (the cluster path),
    the sort additionally becomes **spatial**: one *global* stable sort
    keyed on (dead, direction octant, origin morton cell).  The cluster
    cull quantizes divergence to 128-lane rows (the union of all lanes'
    box hits); unsorted bounce rays in an enclosed scene make every row
    touch nearly every box, while octant+cell-sorted rows stay tight.  The
    key is ordering-only metadata, so radiance remains bitwise identical —
    same permutation machinery, different key.

    Without a spatial key, packing is segment-LOCAL: globally packing by
    liveness alone mixes rays from across the image into each surviving
    row and the per-row cull lists grow.  The spatial key is what makes a
    global sort help instead.

    The net effect is scene-dependent: it wins where dead rows free real
    work (cluster visits) and costs a sort per bounce always.  The renderer
    enables it only for intersectors that declare ``prefers_compaction``
    (the cluster path at large K).
    """
    B = k0.shape
    R_flat = B[0] * B[1]

    def r2(x):  # per-ray scalar -> (B0, 128)
        return x.reshape(B)

    spatial_sort = compact and bool(
        getattr(closest_fn, "prefers_ray_sort", False)
    )
    if spatial_sort and scene.n_lights > 1024:
        # _sorted_any's sort key carries the light id in 10 bits; beyond
        # 1024 lights ids alias and the shadow-sort win degrades
        # (correctness holds — the key is ordering-only metadata).
        import warnings

        warnings.warn(
            f"scene has {scene.n_lights} area lights > 1024: the NEE "
            "shadow-sort key clamps light ids at 1024, so shadow rays for "
            "lights beyond that share a sort bucket and the per-light "
            "row-coherence win degrades (results stay exact).",
            RuntimeWarning, stacklevel=2,
        )
    if spatial_sort:
        # One global sort: the spatial key keeps rows coherent everywhere.
        seg, n_seg = R_flat, 1
    else:
        seg = min(COMPACT_SEG_LANES, R_flat)
        n_seg = R_flat // seg if R_flat % seg == 0 else 1
        if R_flat % seg != 0:
            seg = R_flat

    if spatial_sort:
        # Morton-cell quantization bounds (ordering-only metadata).
        wmin_s = jax.lax.stop_gradient(scene.world_min)
        wext_s = jnp.maximum(
            jax.lax.stop_gradient(scene.world_max) - wmin_s, 1e-6
        )

    def _part1by2(x):
        """Spread the low 10 bits of x to every 3rd bit (Morton helper)."""
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    def _morton_cell(origin):
        """(B0, 128) i32 15-bit Morton cell (5 bits/axis) of the origin."""
        morton = jnp.zeros(origin.shape[1:], jnp.int32)
        for a in range(3):
            q = jnp.clip(
                (origin[a] - wmin_s[a]) / wext_s[a] * 32.0, 0.0, 31.0
            ).astype(jnp.int32)
            morton = morton | (_part1by2(q) << a)
        return morton

    def _spatial_key(origin, direction, active):
        """(B0, 128) i32: dead lanes last, then direction octant, then two
        2-bit per-axis |direction| shares (a ~4x4 angular bin inside the
        octant), then the 5-bit/axis Morton cell of the origin.

        Rays sharing a row after this sort share a tight (direction cone,
        cell) bundle.  The angular bins matter as much as the cell: with
        octant-only granularity a row's cosine-sampled bounce rays span a
        quarter-space and the per-row cull union covers most of the
        scene."""
        dead = (~active).astype(jnp.int32)
        octant = (
            (direction[0] < 0).astype(jnp.int32)
            | ((direction[1] < 0).astype(jnp.int32) << 1)
            | ((direction[2] < 0).astype(jnp.int32) << 2)
        )
        s = (jnp.abs(direction[0]) + jnp.abs(direction[1])
             + jnp.abs(direction[2]) + 1e-9)
        nb = float(1 << _DIR_BITS)
        b1 = jnp.clip(jnp.abs(direction[0]) / s * nb, 0.0, nb - 1.0)
        b2 = jnp.clip(jnp.abs(direction[1]) / s * nb, 0.0, nb - 1.0)
        cone = (b1.astype(jnp.int32) << _DIR_BITS) | b2.astype(jnp.int32)
        cone_w = 2 * _DIR_BITS
        return (
            (dead << (cone_w + 18)) | (octant << (cone_w + 15))
            | (cone << 15) | _morton_cell(origin)
        )

    def _sorted_any(o, d, tmax, excl, li, hit):
        """Shadow query with lane reordering: globally sort the wavefront by
        (shadowless-last, light id, origin Morton cell), run ``any_planar``
        on the sorted arrays, inverse-permute the occlusion bits.

        Pure permutation — per-lane occlusion is exact and independent of
        row grouping (rows only set the *candidate* cluster superset), so
        radiance stays bitwise identical.  The point: NEE picks a light per
        LANE, so pixel-order rows mix up to 128 light targets and their
        per-row cull union covers most of the scene.  Sorted by (light,
        cell), rows share one target and a tight origin bundle."""
        key = (
            ((~hit).astype(jnp.int32) << 26)
            | (jnp.minimum(li, 1023) << 16)     # sort key only: clamp is
            | _morton_cell(o)                   # harmless for correctness
        )
        lane_id = jnp.arange(R_flat, dtype=jnp.int32)
        _, sp = jax.lax.sort(
            (key.reshape(-1), lane_id), num_keys=1, is_stable=True
        )
        _, inv = jax.lax.sort((sp, lane_id), num_keys=1, is_stable=True)
        sm = jnp.stack([
            o[0].reshape(-1), o[1].reshape(-1), o[2].reshape(-1),
            d[0].reshape(-1), d[1].reshape(-1), d[2].reshape(-1),
            tmax.reshape(-1),
            excl.reshape(-1).view(jnp.float32),   # bit-ride, see bounce
        ])[:, sp]                                 # one (8, 1) gather

        def row(i):
            return sm[i].reshape(B)

        occ_s = any_planar(
            jnp.stack([row(0), row(1), row(2)]),
            jnp.stack([row(3), row(4), row(5)]),
            row(6), row(7).view(jnp.int32),
        )
        return occ_s.reshape(-1)[inv].reshape(B)

    n_lights = scene.n_lights
    bg = background[:, None, None]  # (3, 1, 1)
    textured = scene.tex_data.shape[0] > 1

    # Planar-native intersectors (cluster) avoid the (R, 3) <-> (3, B0, 128)
    # relayout at every kernel boundary; row-major intersectors (brute-force
    # oracle, BVH) are wrapped with explicit conversions below.
    closest_planar = getattr(closest_fn, "planar_fn", None)
    any_planar = getattr(any_fn, "planar_fn", None)

    if n_lights > 0:
        # Compact per-light table, derived *inside the traced graph* (so
        # gradients flow from NEE into ke and vertex positions), gathered
        # per ray by the sampled light index.
        lids = scene.light_ids
        light_table_t = jnp.concatenate(
            [
                scene.tri_v0[lids],
                scene.tri_v1[lids],
                scene.tri_v2[lids],
                scene.normal[lids],
                scene.ke[lids],
                scene.light_areas[:, None],
            ],
            axis=1,
        ).T  # (16, L)

    def bounce(state, k):
        origin, direction, throughput, radiance, active, ck0, ck1, perm = state

        if compact:
            # Stable-sort live lanes to the front of each segment.
            if spatial_sort:
                key = _spatial_key(origin, direction, active)
                key = key.reshape(n_seg, seg)
            else:
                key = (~active).reshape(n_seg, seg).astype(jnp.int32)

            # Sort only (key, source-index); move the 16 state arrays
            # with ONE stacked gather.  Each element moves once instead
            # of riding every compare-exchange pass of a 17-operand
            # variadic sort, and stacking makes the gather move
            # contiguous (16, 1) columns instead of 16 scattered reads.
            iota = jnp.broadcast_to(
                jnp.arange(seg, dtype=jnp.int32)[None], (n_seg, seg)
            )
            _, sp = jax.lax.sort((key, iota), num_keys=1, is_stable=True)
            spg = (
                sp + jnp.arange(n_seg, dtype=jnp.int32)[:, None] * seg
            ).reshape(-1)
            def fview(x):
                # bit-preserving ride-along for 32-bit int payloads:
                # the gather only moves bytes, never does arithmetic
                return x.reshape(-1).view(jnp.float32)

            sm = jnp.stack([
                origin[0].reshape(-1), origin[1].reshape(-1),
                origin[2].reshape(-1),
                direction[0].reshape(-1), direction[1].reshape(-1),
                direction[2].reshape(-1),
                throughput[0].reshape(-1), throughput[1].reshape(-1),
                throughput[2].reshape(-1),
                radiance[0].reshape(-1), radiance[1].reshape(-1),
                radiance[2].reshape(-1),
                active.astype(jnp.float32).reshape(-1),   # exact 0/1
                fview(ck0), fview(ck1), fview(perm),
            ])                                       # (16, R_flat)
            sm = sm[:, spg]

            def row(i):
                return sm[i].reshape(B)

            origin = jnp.stack([row(0), row(1), row(2)])
            direction = jnp.stack([row(3), row(4), row(5)])
            throughput = jnp.stack([row(6), row(7), row(8)])
            radiance = jnp.stack([row(9), row(10), row(11)])
            active = row(12) > 0.5
            ck0 = row(13).view(ck0.dtype)
            ck1 = row(14).view(ck1.dtype)
            perm = row(15).view(jnp.int32)

        # Closest-hit + hit resolution (rayTracer.cpp:148-166).  Planar-native
        # intersectors return everything already in (.., B0, 128) layout
        # with shading attributes gathered by the intersector; row-major
        # intersectors get explicit conversions at the boundary.
        if closest_planar is not None:
            res = closest_planar(origin, direction)
            hit = res.hit & active
            bu, bv = res.u, res.v
            A = res.attrs
            # v0*(1-u-v) + v1*u + v2*v == v0 + u*e1 + v*e2 algebraically;
            # fp association differs at ~ulp scale.
            point = A["v0"] + P.pscale(bu, A["e1"]) + P.pscale(bv, A["e2"])
            normal = A["normal"]
            ke_hit = A["ke"]
            btype = A["btype"]
            if textured:
                uvp = (
                    A["uv0"] * (1.0 - bu - bv)[None]
                    + A["uv1"] * bu[None]
                    + A["uv2"] * bv[None]
                )
                kd = _atlas_fetch_planar(scene, A["texid"], uvp, A["kd"])
            else:
                kd = A["kd"]
            if scene.has_specular:
                ks = (
                    _atlas_fetch_planar(scene, A["texid_ks"], uvp, A["ks"])
                    if textured
                    else A["ks"]
                )
                ns = A["ns"]
        else:
            res = closest_fn(P.to_rows(origin), P.to_rows(direction))
            hit, tid = r2(res.hit), res.tid
            bu, bv = r2(res.u), r2(res.v)
            hit = hit & active
            A = res.attrs

            def pv(rows3):  # (R, 3) -> (3, R/128, 128)
                return P.to_planar(rows3, B)

            if A is not None:
                AT = {
                    kk: (pv(vv) if vv.ndim == 2 and vv.shape[1] == 3 else vv)
                    for kk, vv in A.items()
                }
                point = (
                    AT["v0"] + P.pscale(bu, AT["e1"]) + P.pscale(bv, AT["e2"])
                )
                normal = AT["normal"]
                uv_hit = (
                    A["uv0"] * (1.0 - res.u - res.v)[:, None]
                    + A["uv1"] * res.u[:, None]
                    + A["uv2"] * res.v[:, None]
                )
                kd = pv(_atlas_fetch(scene, A["texid"], uv_hit, A["kd"]))
                ke_hit = AT["ke"]
                btype = r2(A["btype"])
                if scene.has_specular:
                    ks = pv(_atlas_fetch(scene, A["texid_ks"], uv_hit, A["ks"]))
                    ns = r2(A["ns"])
            else:
                point = pv(
                    scene.tri_v0[tid] * (1.0 - res.u - res.v)[:, None]
                    + scene.tri_v1[tid] * res.u[:, None]
                    + scene.tri_v2[tid] * res.v[:, None]
                )
                normal = pv(scene.normal[tid])
                kd = pv(texture_kd_lookup(scene, tid, res.u, res.v))
                ke_hit = pv(scene.ke[tid])
                btype = r2(scene.brdf_type[tid])
                if scene.has_specular:
                    ks = pv(texture_ks_lookup(scene, tid, res.u, res.v))
                    ns = r2(scene.shininess[tid])

        # Miss -> background, terminate (rayTracer.cpp:134).
        radiance = radiance + P.pwhere(active & ~hit, throughput * bg, 0.0)

        # Dead-lane parking (virtual compaction): an origin beyond every
        # scene box along +x, pointing +x, guarantees the box cull (cluster
        # path) and AABB tests see misses, so fully-parked 128-lane rows
        # cost trip=0.  Used for non-hit lanes' NEE shadow rays below and
        # for terminated lanes' bounce rays at the end of the body; all
        # radiance/throughput updates are masked on `active`/`hit`, so
        # intersector outputs for parked lanes are never consumed.
        wmax = jax.lax.stop_gradient(scene.world_max)
        wmin = jax.lax.stop_gradient(scene.world_min)
        park_x = wmax[0] + (wmax[0] - wmin[0]) + 1.0
        _zero = jnp.zeros(hit.shape, jnp.float32)
        park_o = jnp.stack(
            [jnp.broadcast_to(park_x, hit.shape), _zero, _zero]
        )
        park_d = jnp.stack([jnp.ones(hit.shape, jnp.float32), _zero, _zero])
        nee_origin = P.pwhere(hit, point + EPS_OFFSET * normal, park_o)

        wo = P.pnormalize(origin - point)
        f_brdf = kd * M_1_PI  # Diffuse::f (brdf.cpp:70)

        if scene.has_specular:
            # Phong extension state (never active in reference-parity mode).
            is_phong = btype == BRDF_PHONG
            n_unit = P.pnormalize(normal)
            wr = reflect_planar(wo, n_unit)
            spec_norm = (ns + 2.0) * (0.5 * M_1_PI)

            def phong_f(wi_dir):
                """Full BRDF value f(wi, wo) = Kd/pi + Ks (ns+2)/2pi cos^ns."""
                cos_r = jnp.maximum(0.0, P.pdot(wr, wi_dir))
                spec = ks * (spec_norm * jnp.power(cos_r, ns))[None]
                return f_brdf + P.pwhere(is_phong, spec, 0.0)

        emitted = P.pwhere(btype == BRDF_EMISSIVE, ke_hit, 0.0)
        direct = P.pwhere(
            jnp.full(B, k == 1, bool),
            P.pscale(jnp.maximum(0.0, P.pdot(wo, normal)), emitted),
            jnp.zeros_like(emitted),
        )

        un = prng.bounce_uniforms_planar(ck0, ck1, k)  # (N_BOUNCE_DIMS, B0, 128)

        if n_lights > 0:
            li = jnp.minimum(
                (un[prng.DIM_LIGHT_SEL] * n_lights).astype(jnp.int32),
                n_lights - 1,
            )                                              # (B0, 128)
            ltid = scene.light_ids[li]
            lrow = light_table_t[:, li.reshape(-1)]         # (16, Rp)
            lrow = lrow.reshape((16,) + B)
            lv0 = lrow[0:3]
            lv1 = lrow[3:6]
            lv2 = lrow[6:9]
            lnormal = lrow[9:12]
            lke = lrow[12:15]
            larea = lrow[15]

            # v0 ~ U(0,1), v1 ~ U(0, 1-v0)  (rayTracer.cpp:96-97)
            b0 = un[prng.DIM_LIGHT_U]
            b1 = un[prng.DIM_LIGHT_V] * (1.0 - b0)
            lpoint = (
                P.pscale(b0, lv0)
                + P.pscale(b1, lv1)
                + P.pscale(1.0 - b0 - b1, lv2)
            )

            to_light = lpoint - point
            dist = P.pnorm(to_light)
            wl = P.pnormalize(to_light)

            wl_q = P.pwhere(hit, wl, park_d)
            if any_planar is not None:
                if spatial_sort:
                    occluded = _sorted_any(
                        nee_origin, wl_q, dist, ltid, li, hit
                    )
                else:
                    occluded = any_planar(nee_origin, wl_q, dist, ltid)
            else:
                occluded = r2(
                    any_fn(
                        P.to_rows(nee_origin),
                        P.to_rows(wl_q),
                        dist.reshape(-1),
                        ltid.reshape(-1),
                    )
                )

            geometric = jnp.maximum(
                0.0,
                P.pdot(normal, wl) * P.pdot(-wl, lnormal) / (1.0 + dist * dist),
            )
            f_nee = phong_f(wl) if scene.has_specular else f_brdf
            nee = lke * (geometric * larea * n_lights)[None] * f_nee
            direct = direct + P.pwhere(~occluded, nee, 0.0)

        # Point-light direct illumination (extension; SceneArrays.pl_pos
        # docstring).  Deterministic sum over all P lights — no RNG consumed,
        # so the counter-based streams are identical with/without them.
        for ipl in range(scene.n_point_lights):
            plp = scene.pl_pos[ipl][:, None, None]        # (3, 1, 1)
            ple = scene.pl_emit[ipl][:, None, None]
            to_l = plp - point
            pdist = P.pnorm(to_l)
            pwl = P.pnormalize(to_l)
            no_excl = jnp.full(B, -1, jnp.int32)
            pwl_q = P.pwhere(hit, pwl, park_d)
            if any_planar is not None:
                pocc = any_planar(nee_origin, pwl_q, pdist, no_excl)
            else:
                pocc = r2(
                    any_fn(
                        P.to_rows(nee_origin),
                        P.to_rows(pwl_q),
                        pdist.reshape(-1),
                        no_excl.reshape(-1),
                    )
                )
            pgeo = jnp.maximum(0.0, P.pdot(normal, pwl)) / (
                1.0 + pdist * pdist
            )
            f_pl = phong_f(pwl) if scene.has_specular else f_brdf
            direct = direct + P.pwhere(~pocc, ple * pgeo[None] * f_pl, 0.0)

        radiance = radiance + P.pwhere(hit, throughput * direct, 0.0)

        # Extend the path (rayTracer.cpp:119-131).
        wi, pdf = sample_wi_diffuse_planar(
            normal, un[prng.DIM_BSDF_U], un[prng.DIM_BSDF_V]
        )
        if not scene.has_specular:
            kmax = jnp.max(f_brdf, axis=0)
            survive = (pdf > 0.0) & (un[prng.DIM_RR] <= kmax)
            cosine = jnp.abs(P.pdot(normal, wi))
            scale = f_brdf * (
                cosine / jnp.where(pdf > 0.0, pdf * kmax, 1.0)
            )[None]
        else:
            # Mixture sampling: diffuse cosine lobe vs Phong lobe, chosen with
            # probability p_spec = maxKs / (maxKd + maxKs); one-sample
            # estimator with the mixture pdf.  Non-Phong lanes reduce exactly
            # to the reference path (p_spec = 0).
            max_kd = jnp.max(kd, axis=0)
            max_ks = jnp.max(ks, axis=0)
            p_spec = jnp.where(
                is_phong, max_ks / jnp.maximum(max_kd + max_ks, 1e-8), 0.0
            )
            wi_s, _ = sample_phong_lobe_planar(
                wr, ns, un[prng.DIM_BSDF_U], un[prng.DIM_BSDF_V]
            )
            choose_spec = un[prng.DIM_LOBE] < p_spec
            wi = P.pwhere(choose_spec, wi_s, wi)

            pdf_d = jnp.maximum(0.0, P.pdot(normal, wi)) * M_1_PI
            pdf_s = phong_pdf_planar(wr, wi, ns)
            pdf_mix = (1.0 - p_spec) * pdf_d + p_spec * pdf_s

            f_at_wi = phong_f(wi)
            # Survival: reference's Kmax for pure-diffuse lanes; energy-bounded
            # clamp for Phong lanes.  Specular lobes below the surface are
            # treated as absorbed.
            q = jnp.where(
                is_phong,
                jnp.clip(max_kd + max_ks, 0.05, 0.95),
                jnp.max(f_brdf, axis=0),
            )
            above = P.pdot(n_unit, wi) > 0.0
            survive = (pdf_mix > 0.0) & (un[prng.DIM_RR] <= q)
            survive = survive & (above | ~is_phong)
            cosine = jnp.abs(P.pdot(normal, wi))
            scale = f_at_wi * (
                cosine / jnp.where(pdf_mix > 0.0, pdf_mix * q, 1.0)
            )[None]

        new_active = hit & survive & (k < depth)
        throughput = P.pwhere(new_active, throughput * scale, throughput)
        # Dead-lane parking (virtual compaction): terminated lanes are moved
        # beyond every scene box along +x, pointing +x, so the next bounce's
        # box culls (cluster path) and AABB tests see guaranteed misses —
        # fully-dead 128-lane rows then cost trip=0 instead of re-tracing
        # stale rays.  Correctness is unaffected: every radiance/throughput
        # update is masked on `active`, so intersector outputs for parked
        # lanes are never consumed.
        origin = P.pwhere(new_active, point + EPS_OFFSET * normal, park_o)
        direction = P.pwhere(new_active, wi, park_d)

        stats = jnp.stack(
            [
                jnp.sum(active, dtype=jnp.float32),
                jnp.sum(hit, dtype=jnp.float32),
            ]
        )
        return (
            origin, direction, throughput, radiance, new_active, ck0, ck1,
            perm,
        ), stats

    init = (
        origins,
        dirs,
        jnp.ones((3,) + B, jnp.float32),
        jnp.zeros((3,) + B, jnp.float32),
        jnp.ones(B, bool),
        k0,
        k1,
        jnp.arange(R_flat, dtype=jnp.int32).reshape(B),
    )
    (_, _, _, radiance, _, _, _, perm), stats = jax.lax.scan(
        bounce, init, jnp.arange(1, depth + 1)
    )
    if compact:
        # Restore original pixel order: segments never exchange lanes, so
        # the carried original-index `perm` is within-segment; one stable
        # 2-D sort keyed on it un-permutes the radiance (same fast minor-
        # axis form as the per-bounce compaction).
        perm_local = perm.reshape(n_seg, seg) - (
            jnp.arange(n_seg, dtype=jnp.int32)[:, None] * seg
        )
        r2d = radiance.reshape(3, n_seg, seg)
        outs = jax.lax.sort(
            (perm_local, r2d[0], r2d[1], r2d[2]), num_keys=1, is_stable=True
        )
        radiance = jnp.stack(outs[1:]).reshape((3,) + B)
    if with_stats:
        return radiance, stats
    return radiance
