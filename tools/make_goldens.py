"""Generate the self-golden regression fixtures (tests/golden/*.exr).

These are tiny frames rendered *by this code* on the CPU backend at fixed
seeds and pinned intersectors, compared tight-allclose in
tests/test_self_golden.py — the estimator-regression guard the loose
structural e2e tests (4x brightness bands) cannot provide.  The reference's
analog is its committed ``renders/*`` artifacts (SURVEY.md §4).

Regenerate (only when an *intentional* estimator change lands, and say so
in the commit message):  python tools/make_goldens.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GOLDEN_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tests", "golden",
)
REFERENCE_DIR = "/root/reference"

# name -> (scene factory kwargs understood by render_fixture)
FIXTURES = {
    # builtin cornell, keyword-format camera, brute oracle
    "cornell_64": dict(scene="builtin:cornell_box", xres=64, yres=64,
                       spp=8, depth=3, intersector="brute"),
    # legacy .rtc parse + point light + texture fetch
    "view_test_150x100": dict(rtc="view_test.rtc", xres=150, yres=100,
                              spp=4, depth=2, intersector="brute"),
    # 19k-tri OBJ + texture atlas through the BVH path
    "nanosuit_132x240": dict(rtc="nanosuit.rtc", xres=132, yres=240,
                             spp=1, depth=2, intersector="bvh"),
    # synthetic sponza-class geometry through the BVH path
    "atrium_160x90": dict(scene="synthetic:atrium:2200", xres=160, yres=90,
                          spp=2, depth=2, intersector="bvh"),
}


def render_fixture(name, spec, cpu=True):
    """Render one fixture deterministically; returns (H, W, 3) f32.

    ``cpu=True`` pins the CPU backend (the goldens are CPU renders);
    ``cpu=False`` renders on the process's default device (pick another
    with ``jax.default_device``).  ``spec["camera"]`` (eye, center, up,
    yview) overrides the scene's camera; synthetic scenes default to
    ``ATRIUM_CAMERA``."""
    import jax

    if cpu:
        jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from chiaroscuro_tpu.render.renderer import render_image
    from chiaroscuro_tpu.scene.config import RenderConfig
    from chiaroscuro_tpu.scene.scene_arrays import load_scene
    from chiaroscuro_tpu.scene.synthetic import ATRIUM_CAMERA

    overrides = [
        "xres", str(spec["xres"]), "yres", str(spec["yres"]),
        "samples", str(spec["spp"]), "k", str(spec["depth"]),
        "intersector", spec["intersector"],
    ]
    if "rtc" in spec:
        cfg = RenderConfig.from_rtc(
            os.path.join(REFERENCE_DIR, spec["rtc"]), overrides)
        cfg.obj_path = os.path.join(REFERENCE_DIR, cfg.obj_path)
    else:
        cfg = RenderConfig.from_tokens(["input", spec["scene"]] + overrides)
    cam = spec.get("camera")
    if cam is None and spec.get("scene", "").startswith("synthetic:"):
        cam = ATRIUM_CAMERA
    for k, v in (cam or {}).items():
        setattr(cfg, {"eye": "vp", "center": "la", "up": "up",
                      "yview": "yview"}[k], v if k != "yview" else float(v))
    scene = load_scene(cfg)
    return np.asarray(render_image(scene, cfg), np.float32)


def main():
    from chiaroscuro_tpu.render.image_io import write_exr

    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for name, spec in FIXTURES.items():
        img = render_fixture(name, spec)
        path = os.path.join(GOLDEN_DIR, f"{name}.exr")
        write_exr(path, img)
        print(f"{name}: {img.shape} mean={img.mean():.5f} "
              f"max={img.max():.3f} -> {path}")


if __name__ == "__main__":
    main()
