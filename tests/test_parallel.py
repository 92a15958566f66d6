"""Sharding tests on the 8-device virtual CPU mesh (SURVEY.md §4 item 5):
the sharded render must be (bitwise-level) identical to the unsharded one
for every mesh shape — the counter-based RNG guarantees it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raymarchrenderer.core.camera import Camera
from raymarchrenderer.parallel.sharding import (
    ShardConfig, auto_shard, gather_image, make_mesh, render_sharded,
)
from raymarchrenderer.render.config import RenderConfig
from raymarchrenderer.render.integrator import render
from raymarchrenderer.scene import builtin

CFG = RenderConfig(width=16, height=16, max_steps=32, max_bounces=2,
                   max_dist=100.0)


def _corners():
    return Camera(aspect=1.0).corner_rays_flat()


@pytest.fixture(scope="module")
def scene_and_params():
    s = builtin.sphere_on_floor()
    return s, s.init_params()


def _reference_image(scene, params, spp):
    img, _ = render(scene, params, CFG, _corners(), spp=spp)
    return np.asarray(img)


@pytest.mark.parametrize("tile,spp_axis", [(4, 1), (1, 4), (2, 4)])
def test_sharded_matches_unsharded(scene_and_params, tile, spp_axis):
    scene, params = scene_and_params
    if len(jax.devices()) < tile * spp_axis:
        pytest.skip("not enough devices")
    mesh = make_mesh(ShardConfig(tile=tile, spp=spp_axis))
    spp = 4
    img = render_sharded(scene, params, CFG, _corners(), mesh, spp)
    ref = _reference_image(scene, params, spp)
    np.testing.assert_allclose(gather_image(img), ref, rtol=1e-5, atol=1e-6)


def _flat(tree):
    return np.concatenate([np.ravel(x) for x in jax.tree.leaves(tree)])


@pytest.mark.parametrize("tile,spp_axis", [(1, 1), (4, 1), (1, 4), (2, 2)])
def test_train_step_update_is_unsharded_grad(scene_and_params, tile,
                                             spp_axis):
    """One sharded SGD step at lr 1 moves the parameters by exactly the
    gradient of the unsharded loss, whatever the mesh: each card's
    contribution is counted once."""
    from raymarchrenderer.parallel.sharding import train_step_sharded
    from raymarchrenderer.render.integrator import render_patch_spp
    scene, params = scene_and_params
    corners, spp = _corners(), 4
    target = jnp.full((16, 16, 3), 0.1, jnp.float32)

    def loss_fn(p):
        c = render_patch_spp(scene, p, CFG, corners, (0, 0), (16, 16),
                             jnp.uint32(0), spp, differentiable=True)
        return jnp.mean((c.stack(-1) / spp - target) ** 2)

    want_loss, want = jax.value_and_grad(loss_fn)(params)
    mesh = make_mesh(ShardConfig(tile=tile, spp=spp_axis))
    with mesh:
        loss, new = train_step_sharded(scene, params, CFG, corners, target,
                                       mesh, spp=spp, lr=1.0)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    np.testing.assert_allclose(_flat(params) - _flat(new), _flat(want),
                               rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("tile,spp_axis", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_l2_loss_and_grads_counts_each_card_once(tile, spp_axis):
    """The shared loss/gradient rule of both train steps, on a stand-in
    render (card (t, s) draws (s + 1)·p over its rows): loss and gradient
    equal the unsharded ones."""
    from jax.sharding import PartitionSpec as P

    from raymarchrenderer.parallel.sharding import _l2_loss_and_grads
    h, w = 8, 4
    norm = jnp.float32(h * w * 3)
    target = jnp.asarray(np.random.RandomState(0).rand(h, w, 3),
                         jnp.float32)
    p = jnp.asarray([0.3, -0.7, 1.1], jnp.float32)

    def shard_fn(p, target):
        si = jax.lax.axis_index("spp")
        render = lambda p: (jnp.broadcast_to(p, (h // tile, w, 3))  # noqa
                            * (si + 1).astype(jnp.float32))
        return _l2_loss_and_grads(render, p, target, spp_axis, norm)

    mesh = make_mesh(ShardConfig(tile, spp_axis))
    loss, grad = jax.jit(jax.shard_map(
        shard_fn, mesh=mesh, in_specs=(P(), P("tile", None, None)),
        out_specs=(P(), P()), check_vma=False))(p, target)
    mean_scale = (spp_axis + 1) / 2.0
    want_loss, want = jax.value_and_grad(
        lambda p: jnp.sum((p * mean_scale - target) ** 2) / norm)(p)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(grad), np.asarray(want),
                               rtol=1e-5)


def test_spectral_train_step_independent_of_mesh():
    """The spectral step on a 2×2 mesh gives the one-card loss, parameters
    and band rows."""
    from raymarchrenderer.parallel.sharding import (
        train_step_spectral_sharded)
    from raymarchrenderer.render.spectral_integrator import spectral_demo
    scene, params, mats = spectral_demo()
    target = jnp.full((16, 16, 3), 0.1, jnp.float32)
    out = {}
    for shape in ((1, 1), (2, 2)):
        mesh = make_mesh(ShardConfig(*shape))
        with mesh:
            loss, new, fit = train_step_spectral_sharded(
                scene, params, mats, CFG, _corners(), target, mesh, spp=4,
                lr=1.0)
        out[shape] = (float(loss), _flat(new),
                      _flat((fit.min_wave, fit.max_wave, fit.power)))
    (l1, p1, b1), (l4, p4, b4) = out[(1, 1)], out[(2, 2)]
    np.testing.assert_allclose(l4, l1, rtol=1e-6)
    np.testing.assert_allclose(p4, p1, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(b4, b1)


def test_auto_shard_covers_devices():
    sc = auto_shard(8)
    assert sc.total() == 8
    sc = auto_shard(4)
    assert sc.total() == 4


def test_mesh_requires_enough_devices():
    with pytest.raises(ValueError):
        make_mesh(ShardConfig(tile=64, spp=64))


class TestFusedSharded:
    def test_fused_sharded_matches_oracle_sharded(self):
        """The Pallas megakernel under shard_map equals the oracle sharded
        render (interpret mode on the CPU mesh)."""
        import numpy as np

        from raymarchrenderer.core.camera import Camera
        from raymarchrenderer.parallel.sharding import (
            ShardConfig, make_mesh, render_sharded)
        from raymarchrenderer.render.config import RenderConfig
        from raymarchrenderer.scene import builtin
        scene = builtin.sphere_on_floor()
        params = scene.init_params()
        cfg = RenderConfig(width=128, height=32, max_steps=48,
                           max_bounces=2, max_dist=100.0)
        corners = Camera(aspect=4.0).corner_rays_flat()
        mesh = make_mesh(ShardConfig(tile=2, spp=2))
        a = np.asarray(render_sharded(scene, params, cfg, corners, mesh,
                                      spp=4, impl="oracle"))
        b = np.asarray(render_sharded(scene, params, cfg, corners, mesh,
                                      spp=4, impl="triton", interpret=True))
        assert a.shape == b.shape == (32, 128, 3)
        # bitwise: the megakernel banks each lane's samples in index order
        # (same order as the oracle's fori_loop) and normalize=False defers
        # the single mean division to the shared code path
        np.testing.assert_array_equal(a, b)

    def test_fused_train_step_matches_oracle(self):
        """The recorded differentiable forward (one recording launch +
        implicit adjoint) yields the bitwise-identical sharded train
        step."""
        import numpy as np

        from raymarchrenderer.core.camera import Camera
        from raymarchrenderer.parallel.sharding import (
            ShardConfig, make_mesh, train_step_sharded)
        from raymarchrenderer.render.config import RenderConfig
        from raymarchrenderer.scene import builtin
        import jax
        import jax.numpy as jnp
        scene = builtin.sphere_on_floor()
        params = scene.init_params()
        cfg = RenderConfig(width=32, height=32, max_steps=48,
                           max_bounces=2, max_dist=100.0)
        corners = Camera(aspect=1.0).corner_rays_flat()
        target = jnp.zeros((32, 32, 3), jnp.float32)
        mesh = make_mesh(ShardConfig(tile=4, spp=2))
        with mesh:
            l0, p0 = train_step_sharded(scene, params, cfg, corners, target,
                                        mesh, spp=4, lr=1e-3)
            l1, p1 = train_step_sharded(scene, params, cfg, corners, target,
                                        mesh, spp=4, lr=1e-3,
                                        march_impl="recorded",
                                        interpret=True)
        assert float(l0) == float(l1)
        for a, b in zip(jax.tree.leaves(p0), jax.tree.leaves(p1)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class TestMultihost:
    def test_single_process_helpers(self):
        import numpy as np

        from raymarchrenderer.parallel import multihost
        assert multihost.init() is False  # single process
        assert multihost.is_primary()
        x = np.arange(12.0).reshape(3, 4)
        got = multihost.gather_to_host0(x)
        np.testing.assert_array_equal(got, x)
        multihost.sync()  # no-op


class TestSpectralSharded:
    def test_spectral_sharded_matches_unsharded(self):
        """`render_sharded_spectral` (per-chip patch origin + normalize=
        False merge) equals the unsharded spectral megakernel bitwise."""
        from raymarchrenderer.kernels.march import render_fused_spectral
        from raymarchrenderer.parallel.sharding import (
            ShardConfig, make_mesh, render_sharded_spectral)
        from raymarchrenderer.render.spectral_integrator import (
            spectral_demo)
        scene, params, mats = spectral_demo()
        cfg = RenderConfig(width=128, height=32, max_steps=48,
                           max_bounces=2, max_dist=100.0)
        corners = Camera(aspect=4.0).corner_rays_flat()
        mesh = make_mesh(ShardConfig(tile=2, spp=2))
        a = np.asarray(render_fused_spectral(
            scene, params, mats, cfg, corners, jnp.uint32(0), n_samples=4,
            interpret=True))
        b = np.asarray(render_sharded_spectral(
            scene, params, mats, cfg, corners, mesh, spp=4, interpret=True))
        assert b.shape == (32, 128, 3)
        # same per-lane banking order per chip; the sharded sum splits the
        # sample axis at the chip boundary, so float re-association is
        # possible in principle — in practice the 2-sample partial sums
        # match the 4-sample prefix sums and the merge is exact
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


class TestRecordedSharded:
    def test_recorded_train_step_matches_oracle(self):
        """The recorded differentiable forward (ONE recording launch per
        chip + XLA shade replay) yields the same sharded train step as the
        oracle path (bitwise on the loss; grads/params to a few ulp from
        unrolled-vs-fori backward association)."""
        from raymarchrenderer.parallel.sharding import (
            ShardConfig, make_mesh, train_step_sharded)
        scene = builtin.sphere_on_floor()
        params = scene.init_params()
        cfg = RenderConfig(width=32, height=32, max_steps=48,
                           max_bounces=2, max_dist=100.0)
        corners = Camera(aspect=1.0).corner_rays_flat()
        target = jnp.zeros((32, 32, 3), jnp.float32)
        mesh = make_mesh(ShardConfig(tile=4, spp=2))
        with mesh:
            l0, p0 = train_step_sharded(scene, params, cfg, corners, target,
                                        mesh, spp=4, lr=1e-3)
            l1, p1 = train_step_sharded(scene, params, cfg, corners, target,
                                        mesh, spp=4, lr=1e-3,
                                        march_impl="recorded",
                                        interpret=True)
        assert float(l0) == float(l1)
        for a, b in zip(jax.tree.leaves(p0), jax.tree.leaves(p1)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-6, atol=1e-7)


class TestPaddedSharding:
    """Round-4 verdict item 8: the mesh layer pads like the kernel instead
    of hard-requiring divisibility — non-divisible heights render
    ceil-rows-per-chip (cropped on return) and non-divisible spp renders
    the remainder as one extra masked sample on chips si < spp_rem.  The
    sample SET is exactly {0..spp-1}, so the image must match unsharded."""

    def test_rows_pad(self, scene_and_params):
        scene, params = scene_and_params
        if len(jax.devices()) < 8:
            pytest.skip("not enough devices")
        cfg = CFG.replace(height=36)  # 36 rows on an 8-tile mesh -> pad 40
        mesh = make_mesh(ShardConfig(tile=8, spp=1))
        img = np.asarray(render_sharded(scene, params, cfg, _corners(),
                                        mesh, spp=4))
        assert img.shape == (36, 16, 3)
        ref, _ = render(scene, params, cfg, _corners(), spp=4)
        np.testing.assert_allclose(img, np.asarray(ref),
                                   rtol=1e-5, atol=1e-6)

    def test_spp_remainder(self, scene_and_params):
        scene, params = scene_and_params
        if len(jax.devices()) < 4:
            pytest.skip("not enough devices")
        mesh = make_mesh(ShardConfig(tile=1, spp=4))
        img = np.asarray(render_sharded(scene, params, CFG, _corners(),
                                        mesh, spp=5))  # 5 % 4 == 1
        ref = _reference_image(scene, params, 5)
        np.testing.assert_allclose(img, ref, rtol=1e-5, atol=1e-6)

    def test_fused_rows_and_spp_pad(self):
        """Fused megakernel path with BOTH axes non-divisible (interpret
        mode on the CPU mesh) equals the padded oracle path."""
        from raymarchrenderer.scene import builtin as bi
        scene = bi.sphere_on_floor()
        params = scene.init_params()
        cfg = RenderConfig(width=128, height=23, max_steps=48,
                           max_bounces=2, max_dist=100.0)  # 23 % 2 != 0
        corners = Camera(aspect=4.0).corner_rays_flat()
        mesh = make_mesh(ShardConfig(tile=2, spp=2))
        a = np.asarray(render_sharded(scene, params, cfg, corners, mesh,
                                      spp=3, impl="oracle"))
        b = np.asarray(render_sharded(scene, params, cfg, corners, mesh,
                                      spp=3, impl="triton", interpret=True))
        assert a.shape == b.shape == (23, 128, 3)
        np.testing.assert_array_equal(a, b)
        ref, _ = render(scene, params, cfg, corners, spp=3)
        np.testing.assert_allclose(a, np.asarray(ref), rtol=1e-5, atol=1e-6)
