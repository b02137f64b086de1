"""Planar vec3 math: vectors-of-structures -> structure-of-vectors.

An elementwise op on an ``(R, 3)`` array works on interleaved components
(stride-3 access, a relayout at every boundary).  Every hot per-ray
quantity is instead kept **2-D over the ray axis** — scalars as
``(R/128, 128)``, vec3 as ``(3, R/128, 128)`` — so each component is one
contiguous array and the intersector boundary needs no transpose.

Convention: ``p`` is a planar vec3 iff ``p.shape == (3, *B)`` for any batch
shape ``B``; per-ray scalars have shape ``B``.  All helpers are
rank-agnostic over ``B``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def pvec(x, y, z):
    """Stack per-ray components (R,) into a planar (3, R) vector."""
    return jnp.stack([x, y, z])


def pdot(a, b):
    """(3, R) x (3, R) -> (R,)."""
    return jnp.sum(a * b, axis=0)


def pcross(a, b):
    return jnp.stack(
        [
            a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
        ]
    )


def pnorm(v):
    # max() clamp keeps the sqrt gradient finite at ||v|| == 0 (a NaN there
    # would poison shared-parameter grads via 0 * NaN accumulation).
    return jnp.sqrt(jnp.maximum(pdot(v, v), 1e-20))


def pnormalize(v):
    inv = jax.lax.rsqrt(jnp.maximum(pdot(v, v), 1e-20))
    return v * inv[None]


def pwhere(mask, a, b):
    """Select planar vectors by a per-ray mask of shape B."""
    return jnp.where(mask[None], a, b)


def pscale(s, v):
    """B * (3, *B)."""
    return s[None] * v


def to_planar(rows, batch_shape=None):
    """(R, 3) -> (3, *B) (B defaults to (R,))."""
    p = rows.T
    if batch_shape is not None:
        p = p.reshape((3,) + tuple(batch_shape))
    return p


def to_rows(planar):
    """(3, *B) -> (prod(B), 3)."""
    return planar.reshape(3, -1).T
