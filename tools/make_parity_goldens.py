"""Regenerate the PACKAGED parity goldens from the reference mount.

The wheel ships each gated 2015 BMP (`utils.parity.GATED_GOLDENS`)
x4-box-downscaled as `raymarchrenderer/data/parity/<name>.npz`
(key "image", uint8 sRGB) so the `parity` verb works without the
source checkout.  The downscale here MUST match `load_golden`'s
box-mean (reshape-mean-uint8) so a PARITY_SCALE=4 run against the
mount and a packaged run measure identical pixels.

Run from a source checkout with /root/reference mounted:
    python tools/make_parity_goldens.py
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from raymarchrenderer.utils import parity


def main():
    out_dir = os.path.join(os.path.dirname(parity.__file__), os.pardir,
                           "data", "parity")
    out_dir = os.path.abspath(out_dir)
    f = parity._PKG_SCALE
    assert parity.have_reference_mount(), \
        "needs the reference mount (source checkout)"
    for name in parity.GATED_GOLDENS:
        # load_golden with the mount present IS the gate's own
        # BMP-then-box-mean path — using it (instead of re-implementing
        # the downscale) makes packaged-vs-mount divergence impossible
        small = parity.load_golden(name, f)
        dst = os.path.join(out_dir, name + ".npz")
        np.savez_compressed(dst, image=small)
        print(f"{name}: -> {small.shape} ({os.path.getsize(dst)} bytes)")


if __name__ == "__main__":
    main()
