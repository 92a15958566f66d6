"""IO tests: BMP/PNG encode, PNG round-trip, checkpoint resume."""
import os
import struct

import jax

import numpy as np

from raymarchrenderer.io.checkpoint import load_checkpoint, save_checkpoint
from raymarchrenderer.io.image import (
    load_png, save_bmp, save_png, timestamp_name, to_srgb_u8,
)
from raymarchrenderer.render.config import RenderConfig


def _gradient(h=16, w=32):
    x = np.linspace(0, 1, w, dtype=np.float32)
    img = np.zeros((h, w, 3), np.float32)
    img[..., 0] = x
    img[..., 1] = 0.25
    return img


class TestImage:
    def test_bmp_header(self, tmp_path):
        p = str(tmp_path / "x.bmp")
        save_bmp(p, _gradient())
        raw = open(p, "rb").read()
        assert raw[:2] == b"BM"
        w, h = struct.unpack("<ii", raw[18:26])
        assert (w, h) == (32, 16)
        bpp = struct.unpack("<H", raw[28:30])[0]
        assert bpp == 24

    def test_png_roundtrip(self, tmp_path):
        p = str(tmp_path / "x.png")
        img = _gradient()
        save_png(p, img)
        back = load_png(p)
        # round trip through 8-bit sRGB: ~1/255 quantization in sRGB space
        assert back.shape == img.shape
        assert np.abs(to_srgb_u8(back).astype(int)
                      - to_srgb_u8(img).astype(int)).max() <= 1

    def test_timestamp_name(self):
        import datetime
        n = timestamp_name("bmp", datetime.datetime(2015, 7, 11, 1, 41, 3))
        assert n == "2015-07-11_01-41-03.bmp"  # Program.cpp:71-84 format

    def test_exr_roundtrip_lossless(self, tmp_path):
        from raymarchrenderer.io.image import load_exr, save_exr
        p = str(tmp_path / "x.exr")
        img = _gradient()
        img[3, 5] = [1e-9, 4e6, -0.25]  # HDR + negative: float32 exact
        save_exr(p, img)
        back = load_exr(p)
        np.testing.assert_array_equal(back, img)

    def test_exr_header_wire_format(self, tmp_path):
        from raymarchrenderer.io.image import save_exr
        p = str(tmp_path / "x.exr")
        save_exr(p, _gradient())
        raw = open(p, "rb").read()
        magic, version = struct.unpack_from("<II", raw, 0)
        assert magic == 20000630 and version == 2
        assert b"channels\x00chlist\x00" in raw
        assert b"compression\x00compression\x00" in raw

    def test_save_image_dispatch_exr(self, tmp_path):
        from raymarchrenderer.io.image import load_exr, save_image
        p = str(tmp_path / "y.exr")
        save_image(p, _gradient())
        np.testing.assert_array_equal(load_exr(p), _gradient())


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        p = str(tmp_path / "ckpt.npz")
        cfg = RenderConfig(width=32, height=16, spp=7, seed=3)
        accum = _gradient()
        save_checkpoint(p, accum, 5.0, cfg)
        st = load_checkpoint(p)
        np.testing.assert_array_equal(st.accum, accum)
        assert st.n == 5.0
        assert st.cfg == cfg

    def test_scene_digest_guard(self, tmp_path):
        """Resume on a checkpoint from a DIFFERENT scene refuses instead of
        silently blending two scenes' accumulation buffers; same scene
        (structure + params) resumes fine, legacy digest-less files load."""
        import pytest

        from raymarchrenderer.io.checkpoint import (SceneMismatchError,
                                                        scene_digest)
        from raymarchrenderer.scene import builtin
        s1 = builtin.sphere_on_floor()
        s2 = builtin.cornell()
        d1 = scene_digest(s1, s1.init_params())
        d1b = scene_digest(s1, s1.init_params())
        d2 = scene_digest(s2, s2.init_params())
        assert d1 == d1b and d1 != d2
        cfg = RenderConfig(width=32, height=16, spp=7)
        p = str(tmp_path / "ckpt.npz")
        save_checkpoint(p, _gradient(), 3.0, cfg, scene_digest=d1)
        st = load_checkpoint(p, expect_scene_digest=d1)
        assert st.scene_digest == d1
        with pytest.raises(SceneMismatchError):
            load_checkpoint(p, expect_scene_digest=d2)
        # digest-less checkpoint: no guard (older files keep loading)
        p2 = str(tmp_path / "old.npz")
        save_checkpoint(p2, _gradient(), 1.0, cfg)
        assert load_checkpoint(p2, expect_scene_digest=d2).scene_digest \
            is None

    def test_param_change_changes_digest(self):
        import jax.numpy as jnp

        from raymarchrenderer.io.checkpoint import scene_digest
        from raymarchrenderer.scene import builtin
        s = builtin.sphere_on_floor()
        params = s.init_params()
        d1 = scene_digest(s, params)
        moved = jax.tree.map(lambda x: x + jnp.float32(0.25), params)
        assert scene_digest(s, moved) != d1


class TestHDR:
    """Radiance RGBE codec: Python decoder vs native decoder vs round-trip."""

    def _make_env(self):
        rng = np.random.default_rng(7)
        # exercise zeros, tiny, >1 and large dynamic range values
        img = rng.random((12, 16, 3)).astype(np.float32)
        img[0, 0] = 0.0
        img[1, 1] = [1e-6, 3e4, 7.5]
        return img

    def test_roundtrip_python(self):
        import tempfile

        from raymarchrenderer.io.hdr import load_hdr, loads_hdr, save_hdr
        img = self._make_env()
        with tempfile.TemporaryDirectory() as d:
            p = os.path.join(d, "e.hdr")
            save_hdr(p, img)
            back = loads_hdr(open(p, "rb").read())
        # RGBE quantization: one shared exponent per pixel, so the error
        # bound is ~1/256 of the pixel's MAX channel, not of each channel
        tol = img.max(axis=-1, keepdims=True) / 250.0 + 1e-7
        assert np.all(np.abs(back - img) <= tol)

    def test_native_matches_python(self):
        import tempfile

        from raymarchrenderer.io import native_bindings
        from raymarchrenderer.io.hdr import loads_hdr, save_hdr
        if not native_bindings.available_hdr():
            import pytest
            pytest.skip("native hdr decoder not built")
        img = self._make_env()
        with tempfile.TemporaryDirectory() as d:
            p = os.path.join(d, "e.hdr")
            save_hdr(p, img)
            data = open(p, "rb").read()
        np.testing.assert_array_equal(loads_hdr(data),
                                      native_bindings.decode_hdr(data))

    def test_rle_scanline_decode(self):
        """Hand-built new-style RLE scanline (run + literal mix)."""
        from raymarchrenderer.io.hdr import loads_hdr
        w, h = 8, 1
        header = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
        res = f"-Y {h} +X {w}\n".encode()
        # each component stream: run of 5 then literal of 3
        comp = bytes([128 + 5, 100, 3, 10, 20, 30])
        line = bytes([2, 2, 0, w]) + comp * 4
        img = loads_hdr(header + res + line)
        assert img.shape == (1, 8, 3)
        # value 100 with exponent 100: 100 * 2^(100-136)
        import math
        np.testing.assert_allclose(img[0, 0], 100 * math.pow(2, -36),
                                   rtol=1e-6)

    def test_env_map_into_scene(self):
        """load_env_map feeds Scene.sky: a constant red env map shades sky
        rays red."""
        import tempfile

        import jax.numpy as jnp

        from raymarchrenderer.core.vecmath import Vec3
        from raymarchrenderer.io.hdr import load_env_map, save_hdr
        from raymarchrenderer.scene import loads_scene
        img = np.zeros((4, 8, 3), np.float32)
        img[..., 0] = 2.0
        with tempfile.TemporaryDirectory() as d:
            p = os.path.join(d, "e.hdr")
            save_hdr(p, img)
            env = load_env_map(p)
        scene = loads_scene('{"materials": [], "objects": []}',
                            env_image=env)
        params = scene.init_params()
        d_ = Vec3(jnp.ones((2, 2)), jnp.zeros((2, 2)), jnp.zeros((2, 2)))
        sky = scene.sky(params, d_)
        np.testing.assert_allclose(np.asarray(sky.x), 2.0, rtol=1e-2)
        np.testing.assert_allclose(np.asarray(sky.y), 0.0, atol=1e-6)


def test_load_bmp_8bit_palette(tmp_path):
    """8-bit palettized BI_RGB BMPs decode through the palette (one 2015
    reference golden — 2015-07-20_20-46.bmp — was saved indexed; the
    loader previously rejected it)."""
    import os

    from raymarchrenderer.io.image import load_bmp

    # synthesize a 6x3 indexed BMP: palette of 4 BGRX entries, 4-byte
    # padded rows, bottom-up storage
    w, h = 6, 3
    pal = bytes([255, 0, 0, 0,      # idx 0 -> blue  (BGR)
                 0, 255, 0, 0,      # idx 1 -> green
                 0, 0, 255, 0,      # idx 2 -> red
                 128, 128, 128, 0])  # idx 3 -> gray
    row = (w + 3) & ~3
    px = bytearray()
    for y in range(h):              # bottom-up rows: y=0 is the LAST row
        for x in range(w):
            px.append((x + y) % 4)
        px += b"\0" * (row - w)
    offset = 14 + 40 + len(pal)
    hdr = (b"BM" + struct.pack("<IHHI", offset + len(px), 0, 0, offset)
           + struct.pack("<IiiHHIIiiII", 40, w, h, 1, 8, 0, len(px),
                         2835, 2835, 4, 0))
    p = str(tmp_path / "pal.bmp")
    with open(p, "wb") as f:
        f.write(hdr + pal + bytes(px))
    img = load_bmp(p)
    assert img.shape == (h, w, 3)
    # top row of the image is the y=h-1 stored row: indices (x+2)%4
    assert tuple(img[0, 0]) == (255, 0, 0)    # idx 2 -> red (RGB)
    assert tuple(img[0, 1]) == (128, 128, 128)
    assert tuple(img[2, 0]) == (0, 0, 255)    # idx 0 -> blue
    assert tuple(img[2, 1]) == (0, 255, 0)

    ref = "/root/reference/RayMarch Renderer/output/2015-07-20_20-46.bmp"
    if os.path.exists(ref):
        gold = load_bmp(ref)
        assert gold.shape == (720, 1280, 3)
        # the era's content: one dark glossy sphere on a gray floor
        assert 40 < gold.mean() < 90
