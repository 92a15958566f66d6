"""Native runtime (C++ via ctypes) parity tests: encoder and scheduler must
be drop-in equivalents of the pure-Python fallbacks."""
import os
import tempfile

import numpy as np
import pytest

from raymarchrenderer.io import native_bindings
from raymarchrenderer.render import scheduler_native
from raymarchrenderer.render.tiles import spiral_tiles, spiral_tiles_py

NATIVE = native_bindings.available()
SCHED = scheduler_native.available()


@pytest.mark.skipif(not SCHED, reason="native scheduler not built")
class TestNativeScheduler:
    @pytest.mark.parametrize("gw,gh", [(1, 1), (4, 4), (3, 5), (8, 2),
                                       (7, 7)])
    def test_spiral_order_matches_python(self, gw, gh):
        assert scheduler_native.spiral_order(gw, gh) == \
            list(spiral_tiles_py(gw, gh))

    def test_spiral_tiles_dispatch(self):
        # the public generator must agree with the python walk either way
        assert list(spiral_tiles(4, 4)) == list(spiral_tiles_py(4, 4))

    def test_finite_schedule(self):
        units = list(scheduler_native.NativeScheduler(2, 2, 3))
        order = list(spiral_tiles_py(2, 2))
        expect = [(x, y, s) for (x, y) in order for s in range(3)]
        assert units == expect

    def test_endless_schedule_cancel(self):
        sched = scheduler_native.NativeScheduler(2, 2, 0)
        got = []
        for i, u in enumerate(sched):
            got.append(u)
            if i == 9:
                sched.cancel()
        order = list(spiral_tiles_py(2, 2))
        expect = [(x, y, p) for p in range(3) for (x, y) in order]
        # one sample per tile per pass, pass index as the sample id
        assert got == expect[:len(got)]
        assert len(got) >= 10

    def test_bad_args(self):
        with pytest.raises(ValueError):
            scheduler_native.NativeScheduler(0, 4, 1)


@pytest.mark.skipif(not NATIVE, reason="native encoder not built")
class TestNativeEncoder:
    def test_srgb_matches_python(self):
        from raymarchrenderer.io.image import _linear_to_srgb_np
        rng = np.random.default_rng(0)
        lin = rng.random((16, 16, 3), np.float32) * 1.2 - 0.1
        nat = native_bindings.linear_to_srgb_u8(lin.astype(np.float32))
        ref = np.clip(np.round(
            _linear_to_srgb_np(lin.astype(np.float32)) * 255.0),
            0, 255).astype(np.uint8)
        assert np.abs(nat.astype(int) - ref.astype(int)).max() <= 1

    def test_bmp_roundtrip_layout(self):
        from raymarchrenderer.io.image import save_bmp
        img = np.random.default_rng(1).random((8, 10, 3)).astype(np.float32)
        with tempfile.TemporaryDirectory() as d:
            p = os.path.join(d, "x.bmp")
            save_bmp(p, img)
            data = open(p, "rb").read()
            assert data[:2] == b"BM"
            assert len(data) == 54 + ((10 * 3 + 3) & ~3) * 8
