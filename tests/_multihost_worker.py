"""Worker process for the real 2-process `jax.distributed` test.

Launched twice by tests/test_multihost2.py (argv: coordinator_port,
process_id).  Each worker owns 4 virtual CPU devices; together they form
one 8-device multi-controller runtime.  Exercises, cross-process:

  * `multihost.init` (real `jax.distributed.initialize`) + `sync`,
  * a `render_sharded` over a GLOBAL (4, 2) mesh whose 'tile' axis spans
    both processes, gathered to host 0 via `gather_to_host0`
    (`process_allgather`) and checked against the unsharded oracle,
  * a (1, 8) all-spp mesh whose psum-merge IS a cross-process collective
    — the replicated result is checked on BOTH processes,
  * one `train_step_sharded` step over the global mesh (loss printed;
    the parent asserts both processes agree).
"""
import os
import sys


def main():
    port, pid = sys.argv[1], int(sys.argv[2])
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4"
                               ).strip()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    import jax
    jax.config.update("jax_platforms", "cpu")

    from raymarchrenderer.parallel import multihost
    try:
        active = multihost.init(f"localhost:{port}", 2, pid)
    except Exception as e:  # noqa: BLE001 — sandbox may forbid sockets
        print(f"INIT_UNAVAILABLE: {type(e).__name__}: {e}", flush=True)
        return 3
    if not active:
        print("INIT_UNAVAILABLE: process_count stayed 1", flush=True)
        return 3
    assert jax.process_count() == 2
    assert jax.device_count() == 8, jax.device_count()
    assert len(jax.local_devices()) == 4
    assert multihost.is_primary() == (pid == 0)
    multihost.sync()
    print("INIT_OK", flush=True)

    import jax.numpy as jnp
    import numpy as np

    from raymarchrenderer.core.camera import Camera
    from raymarchrenderer.parallel.sharding import (ShardConfig,
                                                        make_mesh,
                                                        render_sharded,
                                                        train_step_sharded)
    from raymarchrenderer.render.config import RenderConfig
    from raymarchrenderer.render.integrator import render_sample
    from raymarchrenderer.scene import builtin

    scene = builtin.sphere_on_floor()
    params = scene.init_params()
    cfg = RenderConfig(width=128, height=32, max_steps=48, max_bounces=2,
                       max_dist=100.0)
    corners = Camera(aspect=4.0).corner_rays_flat()

    def oracle_mean(spp):
        return sum(np.asarray(render_sample(scene, params, cfg, corners,
                                            jnp.uint32(s)).stack(-1))
                   for s in range(spp)) / float(spp)

    # -- (4, 2) mesh: 'tile' axis spans the two processes; gather crosses --
    mesh = make_mesh(ShardConfig(tile=4, spp=2))
    img = render_sharded(scene, params, cfg, corners, mesh, spp=4)
    full = multihost.gather_to_host0(img)
    if multihost.is_primary():
        assert full is not None and full.shape == (32, 128, 3), \
            None if full is None else full.shape
        np.testing.assert_allclose(full, oracle_mean(4), rtol=1e-6,
                                   atol=1e-7)
        print("GATHER_OK", flush=True)
    else:
        assert full is None
    multihost.sync()

    # -- (1, 8) mesh: the spp psum-merge is a cross-process collective; the
    # merged image is replicated, so BOTH processes check it locally --
    mesh8 = make_mesh(ShardConfig(tile=1, spp=8))
    img8 = render_sharded(scene, params, cfg, corners, mesh8, spp=8)
    local = np.asarray(jax.device_get(img8))
    np.testing.assert_allclose(local, oracle_mean(8), rtol=1e-6, atol=1e-7)
    print("PSUM_OK", flush=True)
    multihost.sync()

    # -- one cross-process train step --
    target = jnp.zeros((32, 128, 3), jnp.float32)
    with mesh:
        loss, new_params = train_step_sharded(scene, params, cfg, corners,
                                              target, mesh, spp=4, lr=1e-3)
    moved = any(
        not np.array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(new_params)))
    assert moved, "train step did not move any parameter"
    print(f"TRAIN_LOSS {float(loss):.9e}", flush=True)
    multihost.sync()
    print("ALL_OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
