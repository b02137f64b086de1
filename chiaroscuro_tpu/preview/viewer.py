"""Interactive progressive preview — analog of the reference's OpenGL preview.

The reference opens a GLFW window with a fly camera (``src/openglPreview.cpp``).
Headless accelerator hosts have no GL stack, so the preview is a matplotlib
window wired to the same input state machine (``preview/state.py``):

    r          render one progressive layer from the current camera and show
               it (repeated r accumulates samples, openglPreview.cpp:140-148)
    tab        toggle raster walk-through vs the last render
               (openglPreview.cpp:150-156)
    = / -      exposure +/- 0.2, re-tonemap only (openglPreview.cpp:157-173)
    w/a/s/d    fly forward/left/back/right;  e/q up/down (reference key map,
               openglPreview.cpp:181-191);  hold shift = fast
    mouse drag look around (Euler yaw/pitch, camera.cpp:48-62) — raster mode only
    scroll     zoom (FOV 1..90 deg, camera.cpp:64-70) — raster mode only
    escape     quit

The walk-through frame is a device-rendered primary-visibility shading pass
(``preview/raster.py``), standing in for the reference's GL rasterizer.
All state transitions live in :class:`~chiaroscuro_tpu.preview.state.PreviewState`
and are unit-tested headlessly; this module only forwards window events.
"""

from __future__ import annotations

from chiaroscuro_tpu.preview.state import PreviewState


def make_state(renderer) -> PreviewState:
    """Build the preview state with the device raster walk-through wired in."""
    from chiaroscuro_tpu.preview.raster import raster_frame

    closest_fn = renderer.intersectors[0]

    def raster(camera):
        return raster_frame(renderer.scene, renderer.cfg, camera, closest_fn)

    return PreviewState(renderer, raster_fn=raster)


def run_preview(renderer) -> None:
    try:
        import matplotlib

        matplotlib.use("TkAgg")
        import matplotlib.pyplot as plt
    except Exception:
        print("No interactive backend available; rendering one layer instead.")
        cfg = renderer.cfg
        renderer.ray_trace(cfg.vp, cfg.la, cfg.up, cfg.yview)
        return

    state = make_state(renderer)
    cfg = renderer.cfg

    fig, ax = plt.subplots(figsize=(8, 8 * cfg.yres / max(cfg.xres, 1)))
    im = ax.imshow(state.display_image())
    ax.set_axis_off()
    fig.suptitle(
        "chiaroscuro_tpu preview — r: render layer, tab: raster/render, "
        "=/-: exposure, wasdeq+mouse+scroll: fly"
    )

    def redraw():
        im.set_data(state.display_image())
        fig.canvas.draw_idle()

    drag = {"x": None, "y": None}

    def on_key(event):
        key = event.key or ""
        fast = key.startswith("shift+")
        k = key[6:] if fast else key
        if k == "r":
            state.press_r()
        elif k == "tab":
            state.press_tab()
        elif k == "=":
            state.adjust_exposure(+0.2)
        elif k == "-":
            state.adjust_exposure(-0.2)
        elif k == "escape":
            state.press_escape()
            plt.close(fig)
            return
        elif not state.move_key(k, delta_time=0.2, fast=fast):
            return
        redraw()

    def on_press(event):
        drag["x"], drag["y"] = event.x, event.y

    def on_release(event):
        drag["x"] = drag["y"] = None

    def on_motion(event):
        if drag["x"] is None or event.x is None:
            return
        dx = event.x - drag["x"]
        dy = event.y - drag["y"]  # matplotlib y is already bottom-up
        drag["x"], drag["y"] = event.x, event.y
        if state.mouse_move(dx, dy):
            redraw()

    def on_scroll(event):
        if state.scroll(event.step):
            redraw()

    fig.canvas.mpl_connect("key_press_event", on_key)
    fig.canvas.mpl_connect("button_press_event", on_press)
    fig.canvas.mpl_connect("button_release_event", on_release)
    fig.canvas.mpl_connect("motion_notify_event", on_motion)
    fig.canvas.mpl_connect("scroll_event", on_scroll)
    plt.show()
