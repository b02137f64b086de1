"""Device-mesh parallel rendering and gradient all-reduce.

The reference's only parallelism is an OpenMP ``parallel for`` over image rows
on one CPU (``src/rayTracer.cpp:55``).  The replacement here shards the
**pixel grid** over a ``jax.sharding.Mesh`` with ``shard_map``: each device
renders its own row-tile; the counter-based PRNG (``sampling/prng.py``) keys
every sample on the *global* pixel index, so the assembled frame is bitwise
identical for any device count — the BASELINE.json reproducibility contract.

For differentiable rendering, ``sharded_value_and_grad`` runs the loss on each
device's tile and ``psum``s the scene-parameter gradients across the mesh —
the renderer analog of data-parallel gradient all-reduce (scene params are
replicated; rays are the "batch").  XLA hands the psum to NCCL, over NVLink
between the cards of one host.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from chiaroscuro_tpu.geometry.intersect import AnyFn, ClosestFn
from chiaroscuro_tpu.render.renderer import render_samples
from chiaroscuro_tpu.scene.scene_arrays import SceneArrays


def make_tile_mesh(devices: Optional[Sequence] = None, axis: str = "tile") -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    return Mesh(np.asarray(devices), (axis,))


def _pixel_grid(xres: int, yres: int):
    ys, xs = np.meshgrid(
        np.arange(yres, dtype=np.int32),
        np.arange(xres, dtype=np.int32),
        indexing="ij",
    )
    return xs.reshape(-1), ys.reshape(-1)


def render_frame_sharded(
    scene: SceneArrays,
    mesh: Mesh,
    eye,
    center,
    up,
    yview,
    xres: int,
    yres: int,
    n_samples: int,
    seed,
    depth: int,
    background,
    closest_fn: ClosestFn,
    any_fn: AnyFn,
    sample_start: int = 0,
) -> jax.Array:
    """Full frame, row-tiles sharded across ``mesh``. Returns (yres, xres, 3).

    ``yres * xres`` must divide evenly by the mesh size (pad rows if needed).
    """
    axis = mesh.axis_names[0]
    n_dev = mesh.shape[axis]
    xs, ys = _pixel_grid(xres, yres)
    total = xs.shape[0]
    if total % n_dev:
        raise ValueError(f"{total} pixels not divisible by {n_dev} devices")

    @partial(
        jax.shard_map,
        mesh=mesh,
        check_vma=False,  # scan carries mix varying/replicated types
        in_specs=(P(None), P(axis), P(axis)),
        out_specs=P(axis),
    )
    def tile_render(scene_rep, px, py):
        return render_samples(
            scene_rep, eye, center, up, yview, xres, yres, px, py,
            sample_start, n_samples, seed, depth, background,
            closest_fn, any_fn,
        )

    flat = tile_render(scene, jnp.asarray(xs), jnp.asarray(ys))
    return flat.reshape(yres, xres, 3)


def sharded_value_and_grad(
    loss_of_image: Callable[[jax.Array], jax.Array],
    diff_fields: Tuple[str, ...] = ("kd", "ke"),
):
    """Build a pjit-able fn: (scene, render args...) -> (loss, grads).

    ``loss_of_image`` maps the assembled (R, 3) tile radiance to a scalar;
    per-device losses/grads are ``psum``-reduced over the mesh axis so every
    device holds the global gradient w.r.t. the replicated scene parameters.
    """

    def make(mesh: Mesh, render_kwargs: dict):
        axis = mesh.axis_names[0]

        def tile_loss(diff_params: dict, scene: SceneArrays, px, py):
            scene = dataclass_replace(scene, **diff_params)
            img = render_samples(scene, px=px, py=py, **render_kwargs)
            # Mean over *global* pixels: local mean / n_dev, psum below.
            return loss_of_image(img) / mesh.shape[axis]

        @partial(
            jax.shard_map,
            mesh=mesh,
            check_vma=False,
            in_specs=(P(None), P(None), P(axis), P(axis)),
            out_specs=(P(), P(None)),
        )
        def step(diff_params, scene, px, py):
            loss, grads = jax.value_and_grad(tile_loss)(diff_params, scene, px, py)
            loss = jax.lax.psum(loss, axis)
            grads = jax.lax.psum(grads, axis)  # gradient all-reduce
            return loss, grads

        def run(scene: SceneArrays, px, py):
            diff_params = {f: getattr(scene, f) for f in diff_fields}
            return step(diff_params, scene, px, py)

        return run

    return make


def dataclass_replace(obj, **changes):
    import dataclasses

    return dataclasses.replace(obj, **changes)
