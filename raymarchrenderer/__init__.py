"""raymarchrenderer: a differentiable sphere-tracing path tracer in JAX.

Re-creates the capabilities of TheBinaryCodeX/RayMarchRenderer (a 2015
C++/OpenGL progressive SDF path tracer, see SURVEY.md) as an
idiomatic JAX/Pallas framework:

  * `core`     — SDF/CSG math, camera, sampling, spectral transport, RNG
  * `scene`    — JSON node-graph scenes compiled by trace-time function
                 composition (replaces the reference's GLSL string splicer)
  * `render`   — ray generation, the pure-JAX oracle integrators (RGB and
                 spectral), progressive accumulation, tile scheduling
  * `kernels`  — fused Pallas GPU kernels (Triton route) for the
                 march/shade/accumulate loop, and the route chooser
  * `diff`     — differentiable rendering (reparameterized march adjoint)
  * `parallel` — mesh / shard_map tile+spp sharding, multi-host utilities
  * `io`       — image encode/save (BMP/PNG/NPY), checkpoint/resume
  * `app`      — CLI frontend (render / save / bench)
"""

from raymarchrenderer.render.config import RenderConfig, TINY  # noqa: F401
from raymarchrenderer.core.camera import Camera  # noqa: F401

__version__ = "0.1.0"
