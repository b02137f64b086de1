"""Timing + profiling utilities.

The reference's only instrumentation is a wall-clock print per render
(``src/rayTracer.cpp:39,72-73``).  Here:

- :class:`PhaseTimer` — wall-clock accumulation per named phase;
- :func:`trace` — opt-in ``jax.profiler`` trace context for device runs;
- :func:`profile_phases` — a measured per-phase breakdown
  (raygen / closest-hit / shadow / shade+control) of one rendered frame, used
  by the renderer's ``profile`` mode.

Useful-work accounting (active-ray counts per bounce) lives in the integrator
itself (``render/integrator.py`` ``with_stats``) because it must be computed
inside the traced graph; the renderer prints it in its banner.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, Optional

import jax
import jax.numpy as jnp


class PhaseTimer:
    """Accumulates wall-clock per named phase; blocks on device work."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync=None) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                jax.block_until_ready(sync)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name}: {total:.3f}s total, {total / n * 1e3:.1f} ms/call x{n}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """``jax.profiler`` trace when log_dir is set; no-op otherwise."""
    if not log_dir:
        yield
        return
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def issued_ray_queries(xres: int, yres: int, spp: int, depth: int) -> float:
    """Full-width wavefront queries issued: (closest + shadow) per bounce per
    sample per pixel.  Masked/dead lanes ride along — compare with the
    integrator's useful-query stats for SIMD occupancy."""
    return float(xres) * yres * spp * depth * 2


def profile_phases(
    scene,
    closest_fn,
    any_fn,
    eye,
    center,
    up,
    yview: float,
    xres: int,
    yres: int,
    spp: int,
    depth: int,
    seed: int = 0,
    iters: int = 2,
) -> Dict[str, float]:
    """Measured per-phase wall-clock breakdown of one frame (seconds).

    One fused ``jit`` program cannot be timed phase-by-phase from the host, so
    this times four *separately jitted* programs over identical inputs:

    - ``raygen``  — PRNG keys + AA jitter + primary directions;
    - ``closest`` — raygen + ``depth x spp`` closest-hit queries on the primary
      wavefront (re-intersecting the same rays: the pure intersector cost);
    - ``shadow``  — same trip count of any-hit queries;
    - ``full``    — the actual renderer program.

    ``shade+control`` is reported as ``full - closest - shadow - raygen``
    (clamped at 0): the integrator's sampling/shading/masking/scan overhead.
    The decomposition is approximate — bounce rays in ``full`` are less
    coherent than the primary rays re-traced here — but every number is a real
    measurement of a real program on the same shapes.
    """
    import numpy as np

    from chiaroscuro_tpu.geometry import planar as P
    from chiaroscuro_tpu.geometry.camera import (
        camera_basis,
        primary_ray_dirs_planar,
    )
    from chiaroscuro_tpu.render.renderer import render_samples
    from chiaroscuro_tpu.sampling import prng

    # Host (numpy) closure constants throughout — device-array constants are
    # re-fetched to the host at every lowering (see utils/hostconst.py).
    eye = np.asarray(eye, np.float32)
    center = np.asarray(center, np.float32)
    up = np.asarray(up, np.float32)
    yv = float(yview)

    ys, xs = np.meshgrid(
        np.arange(yres, dtype=np.int32),
        np.arange(xres, dtype=np.int32),
        indexing="ij",
    )
    px = xs.reshape(-1)
    py = ys.reshape(-1)
    R = px.shape[0]
    pad = (-R) % 128
    if pad:
        px = np.concatenate([px, px[:1].repeat(pad, 0)])
        py = np.concatenate([py, py[:1].repeat(pad, 0)])
    B = ((R + pad) // 128, 128)
    pixel_idx = (py * xres + px).reshape(B)
    pxf = px.astype(np.float32).reshape(B)
    pyf = py.astype(np.float32).reshape(B)

    closest_planar = getattr(closest_fn, "planar_fn", None)
    any_planar = getattr(any_fn, "planar_fn", None)

    @jax.jit
    def raygen(s):
        lu, dx, dy = camera_basis(eye, center, up, yv, xres, yres)
        def one(acc, smp):
            k0, k1 = prng.base_key(np.uint32(seed), pixel_idx, smp)
            jx, jy = prng.aa_jitter_pair(k0, k1)
            d = primary_ray_dirs_planar(lu, dx, dy, pxf, pyf, jx, jy)
            return acc + d, None
        acc, _ = jax.lax.scan(one, jnp.zeros((3,) + B), jnp.arange(spp))
        return acc

    origins = np.broadcast_to(eye[:, None, None], (3,) + B)

    @jax.jit
    def closest_sweep(s):
        dirs = raygen(s) / spp
        def one(acc, _):
            if closest_planar is not None:
                res = closest_planar(origins, dirs)
                t = res.t
            else:
                res = closest_fn(P.to_rows(origins), P.to_rows(dirs))
                t = res.t.reshape(B)
            return acc + t, None
        acc, _ = jax.lax.scan(one, jnp.zeros(B), jnp.arange(depth * spp))
        return acc

    @jax.jit
    def shadow_sweep(s):
        dirs = raygen(s) / spp
        tmax = jnp.full(B, 1e6, jnp.float32)
        excl = jnp.full(B, -1, jnp.int32)
        def one(acc, _):
            if any_planar is not None:
                occ = any_planar(origins, dirs, tmax, excl)
            else:
                occ = any_fn(
                    P.to_rows(origins), P.to_rows(dirs),
                    tmax.reshape(-1), excl.reshape(-1),
                ).reshape(B)
            return acc + occ.astype(jnp.float32), None
        acc, _ = jax.lax.scan(one, jnp.zeros(B), jnp.arange(depth * spp))
        return acc

    @jax.jit
    def full(s):
        return render_samples(
            s, eye, center, up, yv, xres, yres, px, py,
            np.int32(0), spp, np.uint32(seed), depth,
            np.zeros(3, np.float32), closest_fn, any_fn,
        )

    def timed(fn):
        fn(scene).block_until_ready()         # compile + warm
        best = float("inf")
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(scene).block_until_ready()
            best = min(best, time.perf_counter() - t0)
        return best

    t_raygen = timed(raygen)
    t_closest = max(0.0, timed(closest_sweep) - t_raygen)
    t_shadow = max(0.0, timed(shadow_sweep) - t_raygen)
    t_full = timed(full)
    return {
        "raygen": t_raygen,
        "closest": t_closest,
        "shadow": t_shadow,
        "shade+control": max(0.0, t_full - t_closest - t_shadow - t_raygen),
        "full": t_full,
    }


def format_phase_report(phases: Dict[str, float]) -> str:
    full = max(phases.get("full", 0.0), 1e-12)
    parts = []
    for name in ("raygen", "closest", "shadow", "shade+control"):
        if name in phases:
            parts.append(
                f"{name} {phases[name] * 1e3:.1f} ms"
                f" ({100.0 * phases[name] / full:.0f}%)"
            )
    return f"phase breakdown (full {full * 1e3:.1f} ms): " + ", ".join(parts)
