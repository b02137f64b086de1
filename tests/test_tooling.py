"""The compile-cache helper and chip_smoke.py's refusal to run off the GPU."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_uses_env_dir_untouched(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX's own setting is used and
    the helper sets nothing."""
    import jax

    from chiaroscuro_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch):
    """Without it, the cache goes to the fixed .jax_cache/ of the checkout
    (git-ignored) — never a temporary or per-process name."""
    import jax

    from chiaroscuro_tpu.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        assert path == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert compile_cache.enable_compile_cache() == path   # stable
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("case,passes", [("flips", True), ("bias", False),
                                          ("wrong", False)])
def test_golden_bound_counts_flips_and_catches_bias(monkeypatch, case,
                                                    passes):
    """chip_smoke.py's GPU-vs-golden bound lets a few pixels leave the band
    (a near-tie decision that went the other way) but holds the rest to
    the golden: a 0.1% bias inside the band fails, and so does a render
    with 30% of its pixels wrong."""
    import numpy as np

    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke

    rng = np.random.default_rng(0)
    ref = rng.uniform(0.05, 1.0, (90, 160, 3)).astype(np.float32)
    img = ref * (1 + rng.uniform(-1e-5, 1e-5, ref.shape)).astype(np.float32)
    if case == "flips":
        img[[1, 10, 44, 64], [35, 94, 43, 61]] += 1.0
    elif case == "bias":
        img = img * np.float32(1.001)
    else:
        img[:27] = 0.0
    key = "atrium_160x90/bvh"
    if passes:
        st = chip_smoke._check_image(key, img, ref)
        assert round(st["in_band"] * img[..., 0].size) == img[..., 0].size - 4
        assert len(st["out_of_band"]) == 4
        assert st["image_mean_shift"] > chip_smoke.GOLDEN_BOUNDS[key][2]
    else:
        with pytest.raises(AssertionError):
            chip_smoke._check_image(key, img, ref)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """On a machine without a GPU — and in a directory holding nothing of
    the repo but the script — chip_smoke.py exits non-zero and prints no
    result line."""
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
