"""Tests for the .rtc config parser (reference semantics, scene.cpp:13-72)."""

import os

from chiaroscuro_tpu.scene.config import RenderConfig


def test_defaults_match_reference():
    cfg = RenderConfig.from_tokens([])
    # scene.cpp:63-65 defaults
    assert cfg.render_path == "renders/output.exr"
    assert cfg.k == 3
    assert (cfg.xres, cfg.yres) == (400, 300)
    assert cfg.vp == (0.0, 0.0, 2.0)
    assert cfg.la == (0.0, 0.0, 0.0)
    assert cfg.up == (0.0, 1.0, 0.0)
    assert cfg.yview == 1.0
    assert cfg.use_preview is True
    assert cfg.preview_height == 900
    assert cfg.kdtree_leaf_size == 8
    assert cfg.background == (0.0, 0.0, 0.0)
    assert cfg.samples == 100
    assert cfg.exposure == 5.0


def test_keyword_stream_last_wins():
    cfg = RenderConfig.from_tokens(
        ["xres", "100", "xres", "200", "VP", "1", "2", "3", "no-preview"]
    )
    assert cfg.xres == 200
    assert cfg.vp == (1.0, 2.0, 3.0)
    assert cfg.use_preview is False


def test_comments_and_unknown_tokens_skipped(capsys):
    cfg = RenderConfig.from_tokens(["# a comment", "bogus", "k", "6"])
    assert cfg.k == 6
    assert 'Invalid argument "bogus"' in capsys.readouterr().err


def test_parse_reference_cornell_rtc():
    path = "/root/reference/cornell.rtc"
    if not os.path.exists(path):
        import pytest

        pytest.skip("reference not mounted")
    cfg = RenderConfig.from_rtc(path)
    # cornell.rtc values
    assert cfg.obj_path == "data/CornellBox-Original.obj"
    assert cfg.render_path == "renders/cornell_box.exr"
    assert cfg.k == 6
    assert cfg.samples == 1000
    assert (cfg.xres, cfg.yres) == (768, 768)
    assert cfg.vp == (0.0, 1.0, 2.95)
    assert cfg.la == (0.0, 1.0, 0.0)
    assert cfg.yview == 1.0


def test_cli_args_override_file():
    cfg = RenderConfig.from_rtc(
        os.path.join(os.path.dirname(os.path.dirname(__file__)), "scenes",
                     "cornell.rtc"),
        ["xres", "64", "no-preview"],
    )
    assert cfg.xres == 64
    assert cfg.yres == 768
    assert cfg.use_preview is False
