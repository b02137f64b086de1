"""CLI driver: ``python -m chiaroscuro_tpu [scene.rtc] [key value ...]``.

Mirrors the reference's ``main.cpp:5-21`` flow: parse config, load the scene,
construct the renderer, run either the interactive preview or a one-shot batch
render, and always export the image.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv if argv is None else argv)

    from chiaroscuro_tpu.scene.config import RenderConfig

    cfg = RenderConfig.from_argv(argv)
    if cfg.platform:
        import jax

        jax.config.update("jax_platforms", cfg.platform)
    from chiaroscuro_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from chiaroscuro_tpu.render.renderer import Renderer
    from chiaroscuro_tpu.scene.scene_arrays import load_scene

    # Point-light banner parity (kdtree.cpp:99-104).  Unlike the reference
    # (where point lights are preview-only), the integrator shades them when
    # cfg.use_point_lights is on (render/integrator.py point-light loop) —
    # a documented extension.
    if cfg.light_points:
        print("Point Lights in scene:")
        for lp in cfg.light_points:
            print(
                f"Position {lp.position} of color {lp.color} "
                f"and intesity {lp.intensity}"
            )
    scene = load_scene(cfg)
    renderer = Renderer(scene, cfg)

    if cfg.use_preview:
        from chiaroscuro_tpu.preview.viewer import run_preview

        run_preview(renderer)
    else:
        renderer.ray_trace(cfg.vp, cfg.la, cfg.up, cfg.yview)
        if cfg.profile:
            renderer.profile_phases()

    renderer.export_image(cfg.render_path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
