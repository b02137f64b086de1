"""Renderer: jitted sample loops + progressive-accumulation API.

``render_samples`` is the jittable core: given a tile of pixel coordinates and
a static sample range it returns the Monte-Carlo mean radiance per pixel —
this is the unit that gets sharded over a device mesh in ``parallel/``.

:class:`Renderer` mirrors the reference ``RayTracer`` surface
(``include/rayTracer.hpp:10-27``): ``ray_trace(eye, center, up, yview)``
with progressive layer averaging on an unchanged camera
(``src/rayTracer.cpp:18-33,64``), ``max_val``, ``normalize_image`` and
``export_image``.  Divergences (documented):

- layers are seeded deterministically (``seed + layer``) instead of the
  reference's entropy reseed per render (``rayTracer.cpp:54``), so progressive
  accumulation is exactly reproducible;
- the reference's ``lastUp == lastUp`` self-comparison bug (up changes never
  reset accumulation, ``rayTracer.cpp:24``) is reproduced for parity.
"""

from __future__ import annotations

import time
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from chiaroscuro_tpu.accel import make_intersectors
from chiaroscuro_tpu.geometry.camera import camera_basis, primary_ray_dirs_planar
from chiaroscuro_tpu.render import image_io, tonemap
from chiaroscuro_tpu.render.integrator import AnyFn, ClosestFn, trace_paths_planar
from chiaroscuro_tpu.sampling import prng
from chiaroscuro_tpu.scene.config import RenderConfig
from chiaroscuro_tpu.scene.scene_arrays import SceneArrays


def render_samples(
    scene: SceneArrays,
    eye,
    center,
    up,
    yview,
    xres: int,
    yres: int,
    px: jax.Array,            # (R,) int32 pixel columns of this tile
    py: jax.Array,            # (R,) int32 pixel rows of this tile
    sample_start,             # first sample index (traced ok)
    n_samples: int,           # static: number of samples to average
    seed,
    depth: int,               # static: max path depth (scene.k)
    background,
    closest_fn: ClosestFn,
    any_fn: AnyFn,
    with_stats: bool = False,
    remat: bool = False,
    compact: Optional[bool] = None,
    spp_batch: int = 1,
) -> jax.Array:
    """Mean radiance over samples [sample_start, sample_start+n_samples) for
    each pixel of the tile.  Returns (R, 3) float32.

    Sample loop = ``lax.scan``; every sample's randomness is keyed on the
    global (pixel index, sample index) so the result is bitwise independent of
    tiling/sharding (see ``sampling/prng.py``).

    ``spp_batch`` folds that many samples into ONE wavefront per scan step
    (pixel tile replicated, per-lane sample indices) instead of scanning
    them sequentially — for small scenes the per-bounce kernel launches and
    integrator fixed costs dominate, and batching amortizes them across
    samples (cornell 512x512 @ 16 spp: the 16-step scan issues 96
    intersection calls of 2k rows; spp_batch=16 issues 6 of 32k rows).
    Each (pixel, sample) pair keeps its exact PRNG stream, so the estimator
    is unchanged; only the accumulation order differs (~ulp).  Ignored
    unless it divides ``n_samples``.  Memory scales with spp_batch — keep
    the wavefront at or under ~1 M lanes.

    With ``with_stats=True`` returns ``(img, stats)``, stats = (depth, 2) f32
    useful-query counts summed over samples (see
    :func:`~chiaroscuro_tpu.render.integrator.trace_paths_planar`).

    ``remat=True`` checkpoints the per-sample scan body: reverse-mode then
    stores only the accumulator carry per sample instead of every bounce's
    intermediates (O(pixels) instead of O(pixels * spp) HBM), recomputing
    each sample's forward during the backward pass — the standard
    FLOPs-for-memory trade that makes high-spp differentiable renders fit
    in device memory (e.g. cornell 512x512 @ 500 spp fwd+bwd, BASELINE.md).
    """
    # Concrete inputs stay in numpy end to end here so jitted callers that
    # close over them capture *host* constants (device-array constants are
    # re-fetched to the host at every lowering; see utils/hostconst.py).
    # Traced inputs (the usual `_render_frame_jit` path passes them as jit
    # arguments) stay traced.
    from chiaroscuro_tpu.utils.hostconst import is_traced

    cam_xp = jnp if is_traced(eye) else np
    pix_xp = jnp if is_traced(px, py) else np
    eye = cam_xp.asarray(eye, jnp.float32)
    background = (jnp if is_traced(background) else np).asarray(
        background, jnp.float32
    )
    left_upper, dx, dy = camera_basis(eye, center, up, yview, xres, yres)

    # Planarize the tile once (see geometry/planar.py): every per-sample
    # quantity — keys, jitters, directions, radiance — lives in the
    # (B0, 128) layout end to end; rows only exist at this function's edges.
    R = px.shape[0]
    pad = (-R) % 128
    if pad:
        px = pix_xp.concatenate([px, px[:1].repeat(pad, 0)])
        py = pix_xp.concatenate([py, py[:1].repeat(pad, 0)])
    Rp = R + pad
    SB = spp_batch if (spp_batch > 1 and n_samples % spp_batch == 0) else 1
    if SB > 1:
        # Replicate the tile SB times; replica r advances the sample index
        # by r, so one wavefront carries SB consecutive samples per pixel.
        px = pix_xp.concatenate([px] * SB)
        py = pix_xp.concatenate([py] * SB)
        rep = pix_xp.repeat(
            pix_xp.arange(SB, dtype=np.int32), Rp
        )
    B = (Rp * SB // 128, 128)
    pixel_idx = (py * xres + px).reshape(B)
    pxf = px.astype(jnp.float32).reshape(B)
    pyf = py.astype(jnp.float32).reshape(B)
    origins = cam_xp.broadcast_to(eye[:, None, None], (3,) + B)

    # Bounce compaction is a per-intersector preference: it frees real work
    # only where dead rows cut intersector cost (the cluster path at large
    # K; integrator docstring).
    if compact is None:
        compact = bool(getattr(closest_fn, "prefers_compaction", False))

    # Re-derive intersector buffers (packed cluster matrix, triangle SoA,
    # attribute matrix) from THIS scene value, once, outside the scans.
    # When `scene` is a jit argument (the usual path), the buffers become
    # traced values computed from arguments instead of multi-MB MLIR
    # closure constants (the round-3 sponza 237 s compile cliff), and
    # gradients flow to the scene without callers rebuilding intersectors.
    bind = getattr(closest_fn, "bind_scene", None)
    if bind is not None:
        closest_fn, any_fn = bind(scene)

    def one_sample(acc, s):
        acc_img, acc_stats = acc
        s_idx = (s + rep.reshape(B)) if SB > 1 else s
        k0, k1 = prng.base_key(seed, pixel_idx, s_idx)
        jx, jy = prng.aa_jitter_pair(k0, k1)
        dirs = primary_ray_dirs_planar(left_upper, dx, dy, pxf, pyf, jx, jy)
        radiance, stats = trace_paths_planar(
            scene, origins, dirs, k0, k1, depth, background,
            closest_fn, any_fn, with_stats=True, compact=compact,
        )
        return (acc_img + radiance, acc_stats + stats), None

    init = (
        jnp.zeros((3,) + B, jnp.float32),
        jnp.zeros((depth, 2), jnp.float32),
    )
    body = jax.checkpoint(one_sample, prevent_cse=False) if remat else one_sample
    (total, stats), _ = jax.lax.scan(
        body, init, sample_start + jnp.arange(n_samples // SB) * SB
    )
    from chiaroscuro_tpu.geometry import planar as P

    rows = P.to_rows(total)
    if SB > 1:
        rows = rows.reshape(SB, Rp, 3).sum(axis=0)
    img = rows[:R] * (1.0 / n_samples)
    if with_stats:
        return img, stats
    return img


@partial(
    jax.jit,
    static_argnames=(
        "xres", "yres", "n_samples", "depth", "closest_fn", "any_fn",
    ),
)
def _render_frame_jit(
    scene, eye, center, up, yview, xres, yres, sample_start, n_samples,
    seed, depth, background, closest_fn, any_fn,
):
    ys, xs = jnp.meshgrid(
        jnp.arange(yres, dtype=jnp.int32),
        jnp.arange(xres, dtype=jnp.int32),
        indexing="ij",
    )
    flat, stats = render_samples(
        scene, eye, center, up, yview, xres, yres,
        xs.reshape(-1), ys.reshape(-1), sample_start, n_samples,
        seed, depth, background, closest_fn, any_fn, with_stats=True,
    )
    return flat.reshape(yres, xres, 3), stats


def render_image(
    scene: SceneArrays,
    cfg: RenderConfig,
    eye=None,
    center=None,
    up=None,
    yview: Optional[float] = None,
    sample_start: int = 0,
    n_samples: Optional[int] = None,
    intersectors: Optional[Tuple[ClosestFn, AnyFn]] = None,
    with_stats: bool = False,
) -> jax.Array:
    """Render a full frame (yres, xres, 3) with the config's camera/settings.

    ``with_stats=True`` additionally returns the (depth, 2) useful-query
    counts (active closest / shadow queries, summed over all samples)."""
    closest_fn, any_fn = intersectors or make_intersectors(scene, cfg.intersector)
    n_samples = cfg.samples if n_samples is None else n_samples
    spc = cfg.spp_chunk if cfg.spp_chunk > 0 else n_samples

    total = None
    stats_total = None
    done = 0
    while done < n_samples:
        step = min(spc, n_samples - done)
        img, stats = _render_frame_jit(
            scene,
            jnp.asarray(eye if eye is not None else cfg.vp, jnp.float32),
            jnp.asarray(center if center is not None else cfg.la, jnp.float32),
            jnp.asarray(up if up is not None else cfg.up, jnp.float32),
            jnp.float32(cfg.yview if yview is None else yview),
            cfg.xres,
            cfg.yres,
            jnp.int32(sample_start + done),
            step,
            jnp.uint32(cfg.seed),
            cfg.k,
            jnp.asarray(cfg.background, jnp.float32),
            closest_fn,
            any_fn,
        )
        total = img * step if total is None else total + img * step
        stats_total = stats if stats_total is None else stats_total + stats
        done += step
    img = total * (1.0 / n_samples)
    if with_stats:
        return img, stats_total
    return img


class Renderer:
    """Progressive path-tracing renderer with the reference's accumulation
    semantics (``src/rayTracer.cpp:17-74``)."""

    def __init__(self, scene: SceneArrays, cfg: RenderConfig):
        self.scene = scene
        self.cfg = cfg
        self.intersectors = make_intersectors(scene, cfg.intersector)
        self.pixels = np.zeros((cfg.yres, cfg.xres, 3), np.float32)
        self.max_val = 0.0
        self._layers = 0
        self._last_cam: Optional[Tuple] = None
        self.last_stats: Optional[dict] = None

    def ray_trace(self, eye=None, center=None, up=None, yview=None) -> np.ndarray:
        """One render pass; same-camera passes average progressively."""
        cfg = self.cfg
        eye = tuple(np.asarray(eye if eye is not None else cfg.vp, np.float32))
        center = tuple(np.asarray(center if center is not None else cfg.la, np.float32))
        up = tuple(np.asarray(up if up is not None else cfg.up, np.float32))
        yview = float(cfg.yview if yview is None else yview)

        # Camera-change detection incl. the reference's lastUp==lastUp quirk
        # (rayTracer.cpp:24): `up` intentionally NOT compared.
        cam_key = (eye, center, yview)
        if self._last_cam == cam_key:
            self._layers += 1
        else:
            self._layers = 1
            self._last_cam = cam_key

        print(
            f"Camera at {eye} facing: {center} with up: {up} and yview: {yview}\n"
            f"Rendering image of size {cfg.xres}x{cfg.yres} with "
            f"{self._layers * cfg.samples} samples, using "
            f"{jax.device_count()} device(s)...", end="\t", flush=True,
        )
        t0 = time.perf_counter()
        # Layer i consumes the disjoint sample range [(i-1)*spp, i*spp), so
        # running-averaging N layers is *exactly* a single N*spp-sample render
        # (the reference reseeds from entropy instead, rayTracer.cpp:54 — our
        # determinism is a documented improvement).
        img, stats = render_image(
            self.scene,
            cfg,
            eye=eye,
            center=center,
            up=up,
            yview=yview,
            sample_start=(self._layers - 1) * cfg.samples,
            n_samples=cfg.samples,
            intersectors=self.intersectors,
            with_stats=True,
        )
        img = np.asarray(img)
        stats = np.asarray(stats)
        self.pixels = (self.pixels * (self._layers - 1) + img) / self._layers
        self.max_val = float(self.pixels.max(initial=0.0))
        dt = time.perf_counter() - t0
        # Useful-work accounting (SURVEY.md §5 observability): the wavefront
        # issues full-width queries every bounce; `stats` counts the lanes
        # whose result is consumed.  Mirrors the reference's only
        # instrumentation (timing print, rayTracer.cpp:72-73) + rays/s.
        issued = 2.0 * cfg.xres * cfg.yres * cfg.samples * cfg.k
        useful = float(stats.sum())
        self.last_stats = {
            "seconds": dt,
            "queries_issued": issued,
            "queries_useful": useful,
            "occupancy": useful / max(issued, 1.0),
            "useful_rays_per_sec": useful / max(dt, 1e-12),
            "per_bounce_active": stats[:, 0].tolist(),
            "per_bounce_hit": stats[:, 1].tolist(),
        }
        print(
            f"took {dt:.3f} seconds. "
            f"[{useful / max(dt, 1e-12) / 1e6:.1f} Mray/s useful, "
            f"{issued / max(dt, 1e-12) / 1e6:.1f} Mray/s issued, "
            f"occupancy {100.0 * useful / max(issued, 1.0):.0f}%]"
        )
        return self.pixels

    def profile_phases(self, spp: Optional[int] = None) -> dict:
        """Measured per-phase breakdown of one frame at the config camera
        (see ``utils/profiling.profile_phases``); prints and returns it."""
        from chiaroscuro_tpu.utils import profiling

        cfg = self.cfg
        phases = profiling.profile_phases(
            self.scene, *self.intersectors,
            cfg.vp, cfg.la, cfg.up, cfg.yview,
            cfg.xres, cfg.yres,
            min(cfg.samples, 16) if spp is None else spp, cfg.k,
            seed=cfg.seed,
        )
        print(profiling.format_phase_report(phases))
        return phases

    def normalize_image(self, exposure: Optional[float] = None) -> np.ndarray:
        """Tone-mapped uint8 image (``rayTracer.cpp:198-223``)."""
        e = self.cfg.exposure if exposure is None else exposure
        return tonemap.normalize_image(self.pixels, e)

    # --- durable progressive accumulation (utils/checkpoint.py) -----------
    # The reference loses its in-memory layer accumulation on exit
    # (rayTracer.cpp:18-33); these make long renders resumable.

    def save_state(self, path: str) -> None:
        from chiaroscuro_tpu.utils.checkpoint import AccumulationState

        cam = self._last_cam or (tuple(self.cfg.vp), tuple(self.cfg.la), self.cfg.yview)
        state = AccumulationState(
            pixel_sum=self.pixels.astype(np.float64) * self._layers,
            layers=self._layers,
            samples_per_layer=self.cfg.samples,
            camera=(cam[0], cam[1], tuple(self.cfg.up), cam[2]),
            seed=self.cfg.seed,
        )
        state.save(path)

    def load_state(self, path: str) -> bool:
        """Restore accumulation if compatible; returns True on resume."""
        import os

        from chiaroscuro_tpu.utils.checkpoint import AccumulationState

        if not os.path.exists(path):
            return False
        state = AccumulationState.load(path)
        if state.pixel_sum.shape != (self.cfg.yres, self.cfg.xres, 3):
            return False
        if state.samples_per_layer != self.cfg.samples or state.seed != self.cfg.seed:
            return False
        self.pixels = state.pixels
        self._layers = state.layers
        self._last_cam = (state.camera[0], state.camera[1], state.camera[3])
        self.max_val = float(self.pixels.max(initial=0.0))
        return True

    def export_image(self, path: Optional[str] = None) -> None:
        image_io.write_image(
            path or self.cfg.render_path, self.pixels, self.cfg.exposure
        )
