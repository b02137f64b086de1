"""Scaling-efficiency sweep: timed 1 -> N device renders on one mesh.

BASELINE.md targets >= 80% scaling efficiency from 1 host to N >= 2 hosts.
Real multi-host hardware is not available in this environment, so this
module is written to be *the exact code a pod run reuses*:

- ``measure_scaling`` takes whatever devices the caller passes — the 8
  virtual CPU devices in tests (``xla_force_host_platform_device_count``),
  or ``jax.devices()`` on a multi-GPU host — and times the same
  tile-sharded render (``render_frame_sharded``) at each device count.
- Efficiency is wall-clock based: ``eff(N) = t(1) / (N * t(N))`` for a
  fixed total frame (strong scaling — the reference's OpenMP row loop,
  ``src/rayTracer.cpp:55``, is also strong scaling over a fixed image).

Run directly for a report:  ``python -m chiaroscuro_tpu.parallel.scaling``
(honors JAX_PLATFORMS / XLA_FLAGS, so the virtual-mesh sweep is
``XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu
python -m chiaroscuro_tpu.parallel.scaling``).

Caveat recorded in the report: virtual CPU devices share one socket, so
their efficiency number validates *harness + sharding semantics*, not
interconnect bandwidth; only real devices produce a claimable efficiency.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from chiaroscuro_tpu.accel import make_intersectors
from chiaroscuro_tpu.parallel.sharding import make_tile_mesh, render_frame_sharded
from chiaroscuro_tpu.scene.scene_arrays import SceneArrays


def measure_scaling(
    scene: SceneArrays,
    eye,
    center,
    up,
    yview: float,
    xres: int,
    yres: int,
    n_samples: int,
    depth: int,
    device_counts: Sequence[int] = (1, 2, 8),
    devices: Optional[Sequence] = None,
    intersector: str = "auto",
    iters: int = 2,
    seed: int = 0,
) -> dict:
    """Time the same full-frame render at each device count; return a report.

    Returns ``{"counts": [...], "ms": [...], "efficiency": [...],
    "bitwise_equal": bool, "platform": str}``.  ``efficiency[i]`` is
    relative to the 1-device time; ``bitwise_equal`` asserts the
    counter-based-PRNG shard-invariance contract across every measured
    mesh size (frames compared exactly).
    """
    devices = list(devices if devices is not None else jax.devices())
    counts = [n for n in device_counts if n <= len(devices)]
    closest_fn, any_fn = make_intersectors(scene, intersector)
    eye = jnp.asarray(eye, jnp.float32)
    center = jnp.asarray(center, jnp.float32)
    up = jnp.asarray(up, jnp.float32)
    background = jnp.zeros(3, jnp.float32)

    ms = []
    frames = []
    for n in counts:
        mesh = make_tile_mesh(devices[:n])

        def run():
            return render_frame_sharded(
                scene, mesh, eye, center, up, jnp.float32(yview),
                xres, yres, n_samples, jnp.uint32(seed), depth,
                background, closest_fn, any_fn,
            )

        frame = jax.block_until_ready(run())  # compile + first
        best = float("inf")
        for _ in range(iters):
            t0 = time.perf_counter()
            frame = jax.block_until_ready(run())
            best = min(best, time.perf_counter() - t0)
        ms.append(best * 1e3)
        frames.append(np.asarray(frame))

    t1 = ms[0]
    report = {
        "counts": counts,
        "ms": ms,
        "efficiency": [t1 / (n * t) for n, t in zip(counts, ms)],
        "bitwise_equal": all(np.array_equal(frames[0], f) for f in frames[1:]),
        "platform": jax.default_backend(),
        "config": {
            "res": [xres, yres], "spp": n_samples, "depth": depth,
            "intersector": intersector,
        },
    }
    return report


def format_report(report: dict) -> str:
    lines = [
        f"scaling sweep [{report['platform']}] "
        f"{report['config']['res'][0]}x{report['config']['res'][1]} @ "
        f"{report['config']['spp']}spp depth={report['config']['depth']} "
        f"({report['config']['intersector']})",
        f"  shard-invariance (bitwise): "
        f"{'OK' if report['bitwise_equal'] else 'FAIL'}",
    ]
    for n, t, e in zip(report["counts"], report["ms"], report["efficiency"]):
        lines.append(f"  {n:>3} device(s): {t:8.1f} ms   eff {100 * e:5.1f}%")
    if report["platform"] == "cpu":
        lines.append(
            "  (virtual/CPU mesh: validates harness + sharding semantics, "
            "not the interconnect — efficiency is only claimable on real "
            "devices)"
        )
    return "\n".join(lines)


def main() -> None:
    from chiaroscuro_tpu.scene.builtin import CORNELL_CAMERA, cornell_box
    from chiaroscuro_tpu.scene.scene_arrays import build_scene_arrays

    scene = build_scene_arrays(cornell_box())
    cam = CORNELL_CAMERA
    n_dev = len(jax.devices())
    counts = sorted({1, 2, n_dev} & set(range(1, n_dev + 1))) or [1]
    report = measure_scaling(
        scene, cam["eye"], cam["center"], cam["up"], cam["yview"],
        xres=256, yres=256, n_samples=4, depth=3,
        device_counts=counts,
        intersector="auto",
    )
    print(format_report(report))


if __name__ == "__main__":
    main()
