"""Importance samplers: concentric disk map + cosine-weighted hemisphere.

Branchless (``jnp.where``) reimplementation of the reference's samplers
(``src/brdf.cpp:10-62``), vectorized over ray batches.  The eight-region
concentric square->disk map and the tangent-frame construction reproduce the
reference's math exactly so that renders agree in distribution.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

M_PI = np.float32(np.pi)
M_1_PI = np.float32(1.0 / np.pi)


def concentric_sample_disk(u: jnp.ndarray, v: jnp.ndarray):
    """Map uniforms (u, v) in [0,1)^2 to a uniform point on the unit disk.

    Reference ``concentricSampleDisk`` (``src/brdf.cpp:18-54``): the inputs
    there are uniforms on [-1,1]^2; we map u,v -> sx,sy = 2u-1, 2v-1.
    Returns (dx, dy).
    """
    sx = 2.0 * u - 1.0
    sy = 2.0 * v - 1.0

    abs_zero = (sx == 0.0) & (sy == 0.0)

    # Region select (brdf.cpp:31-50). r is never 0 off the degenerate point
    # within a chosen region, but guard the division anyway.
    r1 = sx
    t1 = jnp.where(sy > 0.0, sy / _safe(r1), 8.0 + sy / _safe(r1))
    r2 = sy
    t2 = 2.0 - sx / _safe(r2)
    r3 = -sx
    t3 = 4.0 - sy / _safe(r3)
    r4 = -sy
    t4 = 6.0 + sx / _safe(r4)

    in_12 = sx >= -sy
    in_1 = sx > sy
    in_3 = sx <= sy

    r = jnp.where(in_12, jnp.where(in_1, r1, r2), jnp.where(in_3, r3, r4))
    theta = jnp.where(in_12, jnp.where(in_1, t1, t2), jnp.where(in_3, t3, t4))
    theta = theta * (M_PI / 4.0)

    dx = jnp.where(abs_zero, 0.0, r * jnp.cos(theta))
    dy = jnp.where(abs_zero, 0.0, r * jnp.sin(theta))
    return dx, dy


def _safe(x):
    return jnp.where(x == 0.0, 1.0, x)


def cosine_sample_hemisphere(u: jnp.ndarray, v: jnp.ndarray):
    """Cosine-distributed direction in local (tangent, bitangent, normal)
    coordinates (``src/brdf.cpp:57-62``). Returns (x, y, z) with z >= 0."""
    dx, dy = concentric_sample_disk(u, v)
    dz = jnp.sqrt(jnp.maximum(0.0, 1.0 - dx * dx - dy * dy))
    return dx, dy, dz


def perpendicular(n: jnp.ndarray) -> jnp.ndarray:
    """A vector perpendicular to n (``src/brdf.cpp:10-15``). n: (..., 3)."""
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    cond = jnp.abs(x) < jnp.abs(y)
    px = jnp.where(cond, 0.0, -z)
    py = jnp.where(cond, -z, 0.0)
    pz = jnp.where(cond, y, x)
    return jnp.stack([px, py, pz], axis=-1)


def _normalize(v: jnp.ndarray) -> jnp.ndarray:
    return v / _safe(jnp.linalg.norm(v, axis=-1, keepdims=True))


def tangent_frame(n: jnp.ndarray):
    """(tangent, bitangent) as the reference builds them
    (``src/brdf.cpp:73-74``): tangent = normalize(perpendicular(n)),
    bitangent = normalize(cross(tangent, n)).  n need not be unit."""
    tangent = _normalize(perpendicular(n))
    bitangent = _normalize(jnp.cross(tangent, n))
    return tangent, bitangent


def reflect(wo: jnp.ndarray, n_unit: jnp.ndarray) -> jnp.ndarray:
    """Mirror direction of ``wo`` about unit normal: 2*dot(n,wo)*n - wo."""
    return 2.0 * jnp.sum(n_unit * wo, axis=-1, keepdims=True) * n_unit - wo


def sample_phong_lobe(wr: jnp.ndarray, ns: jnp.ndarray, u, v):
    """Sample a direction from the Phong lobe pdf (ns+1)/(2pi) cos^ns(alpha)
    about the reflection direction ``wr`` (unit).  Returns (wi, cos_alpha).

    Part of the specular extension (not in the reference integrator —
    ``brdf.hpp:8`` has only Diffuse/Emissive).
    """
    cos_a = jnp.power(jnp.maximum(u, 1e-12), 1.0 / (ns + 1.0))
    sin_a = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_a * cos_a))
    phi = 2.0 * M_PI * v
    tangent, bitangent = tangent_frame(wr)
    wi = _normalize(
        (sin_a * jnp.cos(phi))[..., None] * tangent
        + (sin_a * jnp.sin(phi))[..., None] * bitangent
        + cos_a[..., None] * wr
    )
    return wi, cos_a


def phong_pdf(wr: jnp.ndarray, wi: jnp.ndarray, ns: jnp.ndarray):
    """pdf of :func:`sample_phong_lobe` evaluated at ``wi``."""
    cos_a = jnp.maximum(0.0, jnp.sum(wr * wi, axis=-1))
    return (ns + 1.0) * (0.5 * M_1_PI) * jnp.power(cos_a, ns)


def sample_wi_diffuse(n: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray):
    """Cosine-weighted hemisphere sample about (possibly non-unit) normal n.

    Returns (wi, pdf) with wi unit and pdf = max(0, dot(n, wi)) / pi computed
    against the *raw* normal, exactly as ``Diffuse::sample_wi``
    (``src/brdf.cpp:72-79``).
    """
    tangent, bitangent = tangent_frame(n)
    sx, sy, sz = cosine_sample_hemisphere(u, v)
    wi = _normalize(
        sx[..., None] * tangent + sy[..., None] * bitangent + sz[..., None] * n
    )
    pdf = jnp.maximum(0.0, jnp.sum(n * wi, axis=-1)) * M_1_PI
    return wi, pdf


# ---------------------------------------------------------------------------
# Planar (3, R) variants — the forms the integrator uses (geometry/planar.py).
# Same math as the row-major versions above, verified equivalent in tests.
# ---------------------------------------------------------------------------

from chiaroscuro_tpu.geometry import planar as P  # noqa: E402


def perpendicular_planar(n):
    x, y, z = n[0], n[1], n[2]
    cond = jnp.abs(x) < jnp.abs(y)
    return P.pvec(
        jnp.where(cond, 0.0, -z),
        jnp.where(cond, -z, 0.0),
        jnp.where(cond, y, x),
    )


def tangent_frame_planar(n):
    tangent = P.pnormalize(perpendicular_planar(n))
    bitangent = P.pnormalize(P.pcross(tangent, n))
    return tangent, bitangent


def sample_wi_diffuse_planar(n, u, v):
    """Planar :func:`sample_wi_diffuse`: n (3, R) -> (wi (3, R), pdf (R,))."""
    tangent, bitangent = tangent_frame_planar(n)
    sx, sy, sz = cosine_sample_hemisphere(u, v)
    wi = P.pnormalize(
        P.pscale(sx, tangent) + P.pscale(sy, bitangent) + P.pscale(sz, n)
    )
    pdf = jnp.maximum(0.0, P.pdot(n, wi)) * M_1_PI
    return wi, pdf


def reflect_planar(wo, n_unit):
    return P.pscale(2.0 * P.pdot(n_unit, wo), n_unit) - wo


def sample_phong_lobe_planar(wr, ns, u, v):
    cos_a = jnp.power(jnp.maximum(u, 1e-12), 1.0 / (ns + 1.0))
    sin_a = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_a * cos_a))
    phi = 2.0 * M_PI * v
    tangent, bitangent = tangent_frame_planar(wr)
    wi = P.pnormalize(
        P.pscale(sin_a * jnp.cos(phi), tangent)
        + P.pscale(sin_a * jnp.sin(phi), bitangent)
        + P.pscale(cos_a, wr)
    )
    return wi, cos_a


def phong_pdf_planar(wr, wi, ns):
    cos_a = jnp.maximum(0.0, P.pdot(wr, wi))
    return (ns + 1.0) * (0.5 * M_1_PI) * jnp.power(cos_a, ns)
