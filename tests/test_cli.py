"""CLI frontend tests — the reference-REPL verbs (`CLI.cpp:95-219`) driven
end-to-end through `cmd_repl`, plus argument plumbing regressions."""
import argparse
import io
import os
import sys

import numpy as np


def test_repl_render_and_save(tmp_path, monkeypatch, capsys):
    """The reference REPL session: set samples/size, render, save.
    Regression: the repl's `render` Namespace must carry every attribute
    `cmd_render` reads (metrics/profile/env_map/spectral were missing)."""
    from raymarchrenderer.app import cli

    out = tmp_path / "repl.png"
    monkeypatch.setattr(sys, "stdin", io.StringIO(
        "samples 1\n"
        "image_width 32\n"
        "image_height 32\n"
        "grid_width 2\n"
        "grid_height 2\n"
        "render\n"
        f"save {out}\n"
        "bogus_verb 1\n"
        "quit\n"))
    rc = cli.cmd_repl(argparse.Namespace())
    assert rc == 0
    assert out.exists() and out.stat().st_size > 0
    text = capsys.readouterr().out
    assert "unknown verb: bogus_verb" in text
    # the grid verbs drive the schedule (`CLI.cpp:95-126` parity): a 2x2
    # grid renders 4 spiral tiles
    assert "tile (" in text
    assert "4/4" in text


def test_repl_save_before_render(monkeypatch, capsys):
    from raymarchrenderer.app import cli

    monkeypatch.setattr(sys, "stdin", io.StringIO("save\nquit\n"))
    assert cli.cmd_repl(argparse.Namespace()) == 0
    assert "nothing rendered" in capsys.readouterr().out


def test_render_subcommand_writes_image(tmp_path):
    """`raymarch render` end-to-end through the argparse front door."""
    from raymarchrenderer.app import cli

    out = tmp_path / "cli.png"
    rc = cli.main(["render", "--scene", "sphere_on_floor",
                   "--width", "32", "--height", "32", "--spp", "1",
                   "--max-steps", "64", "--max-bounces", "2",
                   "--out", str(out)])
    assert rc == 0
    assert out.exists()
    from raymarchrenderer.io.image import load_png
    img = load_png(str(out))
    assert img.shape == (32, 32, 3)
    assert np.isfinite(img).all()


def test_module_entry_propagates_exit_codes():
    """`python -m raymarchrenderer.app` must propagate verb exit codes
    (round-4 fix: a bare main() call swallowed them — parity gate
    failures exited 0)."""
    import subprocess
    import sys
    src = open(__import__("raymarchrenderer.app.__main__",
                          fromlist=["__file__"]).__file__).read()
    assert "sys.exit(main())" in src
    r = subprocess.run([sys.executable, "-m", "raymarchrenderer.app",
                        "definitely-not-a-verb"],
                       capture_output=True, text=True)
    assert r.returncode == 2  # argparse error must surface


def test_render_resume_scene_mismatch(tmp_path):
    """CLI-written checkpoints must carry the scene digest so that resuming
    with a DIFFERENT scene refuses (`SceneMismatchError`) instead of
    silently blending two scenes' accumulators (round-4 advisor finding:
    cmd_render computed the digest but never passed it to
    save_checkpoint, leaving the guard inert end-to-end)."""
    import pytest

    from raymarchrenderer.app import cli
    from raymarchrenderer.io.checkpoint import SceneMismatchError

    ck = tmp_path / "render.ckpt"
    common = ["--width", "32", "--height", "32", "--spp", "1",
              "--max-steps", "64", "--max-bounces", "2",
              "--checkpoint", str(ck)]
    rc = cli.main(["render", "--scene", "sphere_on_floor",
                   "--out", str(tmp_path / "a.png")] + common)
    assert rc == 0
    assert ck.exists()
    with pytest.raises(SceneMismatchError):
        cli.main(["render", "--scene", "cornell", "--resume",
                  "--out", str(tmp_path / "b.png")] + common)
    # same scene resumes fine
    rc = cli.main(["render", "--scene", "sphere_on_floor", "--resume",
                   "--spp", "2", "--out", str(tmp_path / "c.png")] + common[:4]
                  + common[6:])
    assert rc == 0


def test_pick_impl_fused_for_any_size_on_gpu(monkeypatch):
    """The fused path pads-and-crops arbitrary frame sizes, so impl
    selection must not re-impose tile divisibility — the reference's own
    1280x720 window (Program.cpp:90) must render on the kernel, never on
    the oracle, wherever a GPU is present."""
    import types

    import jax

    from raymarchrenderer.app import cli

    fake_dev = types.SimpleNamespace(platform="gpu")
    monkeypatch.setattr(jax, "devices", lambda *a, **k: [fake_dev])
    args = argparse.Namespace(impl="auto", width=1280, height=720)
    assert cli._pick_impl(args) == "triton"
    args = argparse.Namespace(impl="auto", width=333, height=17)
    assert cli._pick_impl(args) == "triton"
    args = argparse.Namespace(impl="oracle", width=1280, height=720)
    assert cli._pick_impl(args) == "oracle"


def test_persistent_compile_cache(tmp_path, monkeypatch):
    """`render` wires the persistent XLA compilation cache (utils/cache.py)
    so repeat CLI invocations skip the compile: without
    JAX_COMPILATION_CACHE_DIR the checkout's fixed `.jax_cache/` gains
    entries after a render; `--no-cache`/RAYMARCH_NO_CACHE leave the
    config untouched; with the variable set, the cache is placed from
    outside and nothing is set in code."""
    import jax

    from raymarchrenderer.app import cli
    from raymarchrenderer.utils import cache as ucache

    prev = jax.config.jax_compilation_cache_dir
    prev_min = jax.config.jax_persistent_cache_min_compile_time_secs
    cdir = tmp_path / "jaxcache"
    # stand-in for <checkout>/.jax_cache so the test leaves the repo alone
    monkeypatch.setattr(ucache, "CHECKOUT_CACHE_DIR", str(cdir))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        # disabled path: the kill-switch (conftest defaults it on
        # suite-wide so other tests' cli.main() calls never bind the
        # checkout's cache; set explicitly here so an ambient override
        # can't break the assertion)
        monkeypatch.setenv("RAYMARCH_NO_CACHE", "1")
        assert ucache.enable_persistent_cache() is None
        monkeypatch.delenv("RAYMARCH_NO_CACHE")
        assert jax.config.jax_compilation_cache_dir == prev

        rc = cli.main(["--no-cache", "render", "--scene", "single_sphere",
                       "--width", "40", "--height", "24", "--spp", "1",
                       "--max-steps", "16", "--max-bounces", "1",
                       "--out", str(tmp_path / "a.npy")])
        assert rc == 0
        assert jax.config.jax_compilation_cache_dir == prev
        assert not cdir.exists()

        # placed from outside: returned as is, nothing set in code
        outside = tmp_path / "outside"
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(outside))
        assert ucache.enable_persistent_cache() == str(outside)
        assert jax.config.jax_compilation_cache_dir == prev
        assert not cdir.exists()
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")

        # enabled: the front door points jax at the dir and a render
        # populates it (a size nothing else compiled, so the compile
        # can't be an in-process jit-cache hit)
        rc = cli.main(["render", "--scene", "single_sphere",
                       "--width", "56", "--height", "24", "--spp", "1",
                       "--max-steps", "16", "--max-bounces", "1",
                       "--out", str(tmp_path / "b.npy")])
        assert rc == 0
        assert jax.config.jax_compilation_cache_dir == str(cdir)
        assert any(cdir.iterdir()), "no cache entries written"
    finally:
        from jax.experimental.compilation_cache import (compilation_cache
                                                        as cc)
        jax.config.update("jax_compilation_cache_dir", prev)
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          prev_min)
        cc.reset_cache()  # unbind the tmpdir-backed cache instance
