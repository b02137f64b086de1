"""Counter-based PRNG streams, keyed on global (pixel, sample, bounce).

Replaces the reference's per-OpenMP-thread mutable RNG engines
(``prng.hpp`` / ``PRNG::rng[omp_get_thread_num()]``, SURVEY.md C12) with
stateless Threefry-2x32 blocks (the public Random123 counter-based generator,
same core as ``jax.random``) evaluated over *global* counters:

    (k0, k1)      = threefry((0, seed),    (pixel_idx, sample_idx))
    jitter bits   = threefry((k0, k1),     (JITTER_TAG, 0))
    bounce-k bits = threefry((k0, k1),     (k, block))   block = 0..3

Because every random number is a pure function of (seed, global pixel index,
sample index, bounce index) — never of the device/shard that computes it —
renders are **bitwise identical for any sharding of the pixel grid** and for
any chunking of samples.  This is the reproducibility contract
from BASELINE.json ("bitwise reproducible per shard").

The generator is implemented here (20-round Threefry-2x32) rather than via
``jax.random`` so the whole stream can be evaluated **in the planar layout**
(``geometry/planar.py``): all blocks are elementwise u32 ops on (B0, 128)
arrays — full (8, 128)-tile VPU utilization, zero relayouts — where the
``vmap``-over-rays formulation materialized (R, 7) buffers using 7 of 128
lanes.

Per-bounce consumption layout (fixed, so streams never shift):

    dim 0: light selection u      (scene.cpp:79-82 uniform light pick)
    dim 1: light bary u0          (rayTracer.cpp:96)
    dim 2: light bary u1          (rayTracer.cpp:97, scaled by (1-u0))
    dim 3: russian roulette       (rayTracer.cpp:126)
    dim 4: bsdf concentric-disk x (brdf.cpp:20)
    dim 5: bsdf concentric-disk y (brdf.cpp:21)
    dim 6: diffuse-vs-specular lobe pick (Phong extension)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

DIM_LIGHT_SEL = 0
DIM_LIGHT_U = 1
DIM_LIGHT_V = 2
DIM_RR = 3
DIM_BSDF_U = 4
DIM_BSDF_V = 5
DIM_LOBE = 6          # diffuse-vs-specular lobe pick (Phong extension)
N_BOUNCE_DIMS = 7

_JITTER_TAG = 0x51A77E12  # distinct from any bounce index

_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def _rotl(x, n: int):
    return (x << n) | (x >> (32 - n))


def threefry2x32(k0, k1, c0, c1):
    """One Threefry-2x32 block (20 rounds): (key0, key1, ctr0, ctr1) ->
    (out0, out1).  Elementwise over broadcastable uint32 arrays."""
    k0 = jnp.asarray(k0, jnp.uint32)
    k1 = jnp.asarray(k1, jnp.uint32)
    ks = (k0, k1, k0 ^ k1 ^ jnp.uint32(_PARITY))
    x0 = jnp.asarray(c0, jnp.uint32) + ks[0]
    x1 = jnp.asarray(c1, jnp.uint32) + ks[1]
    for i in range(5):
        for r in _ROT_A if i % 2 == 0 else _ROT_B:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + jnp.uint32(i + 1)
    return x0, x1


def uniform_from_bits(bits):
    """u32 -> f32 in [0, 1): set exponent for [1, 2), keep 23 mantissa bits,
    subtract 1 (the standard bitcast construction)."""
    f = jax.lax.bitcast_convert_type(
        jnp.uint32(0x3F800000) | (bits >> 9), jnp.float32
    )
    return f - 1.0


def base_key(seed, pixel_idx, sample_idx):
    """(k0, k1) for (pixel, sample) pairs; shapes follow ``pixel_idx``.
    ``pixel_idx`` is the *global* linear pixel index ``y * xres + x`` —
    shard-invariant by construction."""
    return threefry2x32(
        jnp.uint32(0),
        jnp.asarray(seed, jnp.uint32),
        jnp.asarray(pixel_idx, jnp.uint32),
        jnp.asarray(sample_idx, jnp.uint32),
    )


def aa_jitter_pair(k0, k1):
    """(jx, jy) stratified-AA jitters in [0,1) (``rayTracer.cpp:61``),
    each shaped like ``k0``."""
    b0, b1 = threefry2x32(k0, k1, jnp.uint32(_JITTER_TAG), jnp.uint32(0))
    return uniform_from_bits(b0), uniform_from_bits(b1)


def bounce_uniforms_planar(k0, k1, bounce):
    """(N_BOUNCE_DIMS, *B) uniforms for one path vertex, B = k0.shape."""
    c0 = jnp.asarray(bounce, jnp.uint32)
    outs = []
    for blk in range((N_BOUNCE_DIMS + 1) // 2):
        b0, b1 = threefry2x32(k0, k1, c0, jnp.uint32(blk))
        outs.append(uniform_from_bits(b0))
        outs.append(uniform_from_bits(b1))
    return jnp.stack(outs[:N_BOUNCE_DIMS])


# ---------------------------------------------------------------------------
# Row-major convenience wrappers (tests, external callers).  Keys are raw
# uint32 pairs stacked on the trailing axis: (..., 2).
# ---------------------------------------------------------------------------


def pixel_sample_key(seed, pixel_idx, sample_idx) -> jax.Array:
    """(2,) u32 key for one (pixel, sample) pair."""
    k0, k1 = base_key(seed, pixel_idx, sample_idx)
    return jnp.stack(jnp.broadcast_arrays(k0, k1), axis=-1)


def pixel_sample_keys(seed, pixel_idx: jax.Array, sample_idx) -> jax.Array:
    """(R, 2) u32 keys for a batch of pixel indices."""
    return pixel_sample_key(seed, pixel_idx, sample_idx)


def aa_jitter(key: jax.Array) -> jax.Array:
    """(..., 2) key -> (..., 2) AA jitter in [0,1)."""
    jx, jy = aa_jitter_pair(key[..., 0], key[..., 1])
    return jnp.stack([jx, jy], axis=-1)


def aa_jitter_batch(keys: jax.Array) -> jax.Array:
    return aa_jitter(keys)


def bounce_uniforms(key: jax.Array, bounce) -> jax.Array:
    """(N_BOUNCE_DIMS,) uniforms for one path vertex."""
    return bounce_uniforms_planar(key[..., 0], key[..., 1], bounce)


def bounce_uniforms_batch(keys: jax.Array, bounce) -> jax.Array:
    """(R, N_BOUNCE_DIMS) uniforms for a wavefront of R rays at one bounce."""
    return jnp.moveaxis(
        bounce_uniforms_planar(keys[..., 0], keys[..., 1], bounce), 0, -1
    )
