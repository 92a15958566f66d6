"""The GPU kernel route as far as the CPU can see it.

* Every kept kernel lowers to a Triton custom call for CUDA — the Pallas
  Triton lowering runs here (the GPU's own compiler only on the card).
* The route chooser, the parameter-shipping helper and the launch-block
  rule are plain Python.
* Tests marked `gpu` run the compiled kernels against the plain reference;
  they skip here and run on the card through `python chip_smoke.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import export

from raymarchrenderer.core.camera import Camera
from raymarchrenderer.kernels import march as kmarch
from raymarchrenderer.kernels.record import (trace_record_fused,
                                             trace_record_fused_spectral)
from raymarchrenderer.kernels.route import kernel_route
from raymarchrenderer.kernels.ship import next_pow2, pack, unpack
from raymarchrenderer.render.config import RenderConfig
from raymarchrenderer.render.spectral_integrator import spectral_demo
from raymarchrenderer.scene import builtin

TRITON_CALL = "__gpu$xla.gpu.triton"
CFG = RenderConfig(width=48, height=20, max_steps=64, max_bounces=3,
                   max_dist=100.0)
CORNERS = Camera(aspect=48 / 20).corner_rays_flat()


def _two_light_scene():
    b = builtin.SceneBuilder()
    m = b.diffuse([0.7, 0.7, 0.7])
    b.box(m, [0, -0.025, 0], [16, 0.05, 16])
    b.sphere(m, [0, 1, 0], 1.0)
    b.light([4, 6, -3], 40.0, 0.5)
    b.light([-4, 5, 2], 20.0, 0.5)
    b.light([0, 8, 4], 10.0, 0.3)
    return b.build()


def _case(name):
    """(fn, args): one kept kernel at a small shape."""
    sample = jnp.uint32(0)
    if name in ("rgb", "nee", "dispersion", "env"):
        scene = {"rgb": builtin.sphere_on_floor, "nee": builtin.nee_demo,
                 "dispersion": builtin.glass_demo,
                 "env": builtin.env_demo}[name]()
        cfg = CFG.replace(separate_channels=name == "dispersion")

        def fn(p, c):
            return kmarch.render_fused(scene, p, cfg, c, sample, n_samples=3,
                                       direct_light=name == "nee")
        return fn, (scene.init_params(), CORNERS)
    if name == "spectral":
        scene, params, mats = spectral_demo()

        def fn(p, c):
            return kmarch.render_fused_spectral(scene, p, mats, CFG, c,
                                                sample, n_samples=3)
        return fn, (params, CORNERS)
    if name == "record-spectral":
        scene, params, mats = spectral_demo()

        def fn(p, c):
            return trace_record_fused_spectral(
                scene, p, mats, CFG, c, (0, 0), (20, 48), sample,
                n_samples=2)
        return fn, (params, CORNERS)
    # recorders; "record-odd": B·S = 3·3 and L = 3 — no power-of-two bank
    scene = {"record": builtin.sphere_on_floor,
             "record-nee": builtin.csg_demo,
             "record-odd": _two_light_scene}[name]()
    S = 3 if name == "record-odd" else 2

    def fn(p, c):
        return trace_record_fused(scene, p, CFG, c, (0, 0), (20, 48),
                                  sample, direct_light=name != "record",
                                  n_samples=S)
    return fn, (scene.init_params(), CORNERS)


CASES = ["rgb", "nee", "dispersion", "env", "spectral", "record",
         "record-nee", "record-spectral", "record-odd"]


@pytest.mark.parametrize("name", CASES)
def test_kernel_lowers_to_triton(name):
    fn, args = _case(name)
    abstract = jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(jnp.shape(x), jnp.asarray(x).dtype),
        args)
    exp = export.export(
        jax.jit(fn), platforms=("cuda",),
        disabled_checks=[export.DisabledSafetyCheck.custom_call(
            TRITON_CALL)])(*abstract)
    assert TRITON_CALL in exp.mlir_module()


def test_record_odd_banks_fold_in_interpret():
    """Non-power-of-two bank depths (B·S = 9, B·S·L = 27) need no padding:
    each record is a scatter store.  The folded layout matches the
    replay's (B·L, S·H, W) contract and misses keep their init values."""
    scene = _two_light_scene()
    rec = trace_record_fused(scene, scene.init_params(), CFG, CORNERS,
                             (0, 0), (20, 48), jnp.uint32(0),
                             direct_light=True, interpret=True, n_samples=3)
    assert rec["t"].shape == (3, 60, 48)
    assert rec["sd"].shape == (9, 60, 48)
    t, hit = np.asarray(rec["t"]), np.asarray(rec["hit"])
    assert np.all(t[hit == 0] == CFG.max_dist)
    assert np.all(t[hit == 1] < CFG.max_dist)
    assert set(np.unique(np.asarray(rec["sd"]))) <= {0.0, np.float32(3.4e38)}


class TestRoute:
    def test_gpu_is_triton(self):
        assert kernel_route("gpu") == "triton"

    def test_cpu_is_oracle(self):
        assert kernel_route("cpu") == "oracle"
        assert kernel_route() == "oracle"  # the suite runs on the CPU

    def test_other_platforms_refused(self):
        with pytest.raises(RuntimeError, match="no kernel route"):
            kernel_route("metal")


class TestShip:
    @pytest.mark.parametrize("n,want", [(0, 1), (1, 1), (3, 4), (4, 4),
                                        (5, 8), (17, 32)])
    def test_next_pow2(self, n, want):
        assert next_pow2(n) == want

    def test_rows_are_power_of_two_and_split_by_dtype(self):
        tree = {"a": jnp.arange(3, dtype=jnp.float32),
                "b": jnp.float32(2.5),
                "k": jnp.asarray([1, -2], jnp.int32)}
        rows, _ = pack(tree)
        assert [r.shape for r in rows] == [(1, 4), (1, 2)]
        assert rows[0].dtype == jnp.float32 and rows[1].dtype == jnp.int32
        np.testing.assert_array_equal(np.asarray(rows[0]),
                                      [[0.0, 1.0, 2.0, 2.5]])

    def test_float_only_tree_ships_one_row(self):
        rows, _ = pack({"x": jnp.ones((5, 3), jnp.float32)})
        assert len(rows) == 1 and rows[0].shape == (1, 16)

    def test_unpack_rebuilds_scalars(self):
        tree = {"v": jnp.asarray([1.0, 2.0, 3.0]),
                "m": jnp.arange(6, dtype=jnp.float32).reshape(2, 3),
                "s": jnp.float32(7.0),
                "u": jnp.uint32(0xFFFFFFFF),
                "k": jnp.asarray([3, -4], jnp.int32),
                "flag": jnp.asarray(True),
                "empty": np.zeros((0, 3), np.float32)}
        rows, layout = pack(tree)
        out = unpack(layout, *rows)
        # non-scalar leaves: object arrays of scalars, indexed like arrays
        assert out["v"].shape == (3,) and float(out["v"][2]) == 3.0
        assert out["m"].shape == (2, 3) and float(out["m"][1, 2]) == 5.0
        assert float(out["s"]) == 7.0
        assert out["u"].dtype == jnp.uint32 and int(out["u"]) == 0xFFFFFFFF
        assert [int(x) for x in out["k"]] == [3, -4]
        assert bool(out["flag"]) is True
        assert out["empty"].shape == (0, 3)

    def test_scene_params_roundtrip_in_kernel(self):
        """A whole scene pytree + band table rebuilt inside an interpreted
        Triton-route kernel gives the same map as the plain arrays."""
        from jax.experimental import pallas as pl

        from raymarchrenderer.core.vecmath import Vec3
        scene, params, mats = spectral_demo()
        rows, layout = pack({"p": params, "m": mats})
        pts = Vec3.full((8, 16), 0.5, 1.25, -0.75)
        want = scene.map_dist(params, pts, 100.0)

        def kernel(f_ref, i_ref, o_ref):
            t = unpack(layout, f_ref, i_ref)
            assert int(t["m"].kind.shape[0]) == len(scene.materials)
            o_ref[...] = scene.map_dist(t["p"], Vec3.full(
                (8, 16), 0.5, 1.25, -0.75), 100.0)

        got = pl.pallas_call(
            kernel, out_shape=jax.ShapeDtypeStruct((8, 16), jnp.float32),
            backend="triton", interpret=True)(*rows)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


class TestLaunchBlock:
    def test_pads_to_block_multiple(self):
        assert kmarch.launch_block((16, 16), (720, 1280)) == (16, 16, 720,
                                                                1280)
        assert kmarch.launch_block((16, 16), (13, 149)) == (16, 16, 16, 160)

    def test_clamps_to_small_planes(self):
        assert kmarch.launch_block((16, 32), (5, 3)) == (8, 4, 8, 4)

    def test_refuses_non_power_of_two(self):
        with pytest.raises(ValueError, match="powers of two"):
            kmarch.launch_block((12, 16), (64, 64))


# ---- on the card -----------------------------------------------------------

# A frame big enough that one path flipped by the kernel's and XLA's
# different FMA contraction moves the image mean by < 1e-4 relative; the
# strict schedule (no lazy miss test, no cadence pass) leaves the FMA
# contraction as the only difference.
CARD_CFG = RenderConfig(width=128, height=64, max_steps=256, max_bounces=4,
                        relax_omega=2.0, normal_taps=4)
CARD_CORNERS = Camera(aspect=2.0).corner_rays_flat()
STRICT = dict(lazy_miss=False, regen_cadence=0)


def _compare(a, b):
    """Each channel mean within 1e-3 relative, at most 1e-3 of pixels off
    by more than 1e-3 (chip_smoke.py holds the 1024² frames to 1e-4)."""
    a, b = np.asarray(a), np.asarray(b)
    ma, mb = a.mean(axis=(0, 1)), b.mean(axis=(0, 1))
    assert np.all(np.abs(ma - mb) <= 1e-3 * np.abs(mb)), (ma, mb)
    assert float((np.abs(a - b) > 1e-3).mean()) <= 1e-3


def _oracle_mean(one, params, spp):
    return sum(np.asarray(one(params, jnp.uint32(s)), np.float64)
               for s in range(spp)) / spp


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["rgb", "nee", "dispersion", "env"])
def test_compiled_rgb_kernel_matches_oracle(gpu, name):
    from raymarchrenderer.render.integrator import render_sample
    scene = {"rgb": builtin.sphere_on_floor, "nee": builtin.nee_demo,
             "dispersion": builtin.glass_demo,
             "env": builtin.env_demo}[name]()
    cfg = CARD_CFG.replace(separate_channels=name == "dispersion")
    nee = name == "nee"
    params = scene.init_params()
    with jax.default_matmul_precision("highest"):
        got = kmarch.render_fused(scene, params, cfg, CARD_CORNERS,
                                  jnp.uint32(0), n_samples=4,
                                  direct_light=nee, **STRICT)
        one = jax.jit(lambda p, s: render_sample(
            scene, p, cfg, CARD_CORNERS, s, direct_light=nee).stack(-1))
        want = _oracle_mean(one, params, 4)
    _compare(got, want)


@pytest.mark.gpu
def test_compiled_spectral_kernel_matches_oracle(gpu):
    from raymarchrenderer.render.spectral_integrator import (
        render_sample_spectral)
    scene, params, mats = spectral_demo()
    got = kmarch.render_fused_spectral(scene, params, mats, CARD_CFG,
                                       CARD_CORNERS, jnp.uint32(0),
                                       n_samples=4, **STRICT)
    one = jax.jit(lambda p, s: render_sample_spectral(
        scene, p, mats, CARD_CFG, CARD_CORNERS, s).stack(-1))
    _compare(got, _oracle_mean(one, params, 4))


@pytest.mark.gpu
def test_compiled_recorder_matches_interpreter(gpu):
    """The compiled recorder banks what the interpreted one banks."""
    scene = _two_light_scene()
    args = (scene, scene.init_params(), CFG, CORNERS, (0, 0), (20, 48),
            jnp.uint32(0))
    got = trace_record_fused(*args, direct_light=True, n_samples=3,
                             lazy_miss=False)
    want = trace_record_fused(*args, direct_light=True, n_samples=3,
                              interpret=True)
    for k in ("mid", "hit", "sd"):
        assert float((np.asarray(got[k]) != np.asarray(want[k])).mean()) \
            <= 1e-3, k
    dt = np.abs(np.asarray(got["t"]) - np.asarray(want["t"]))
    assert float((dt > 1e-3).mean()) <= 1e-3
