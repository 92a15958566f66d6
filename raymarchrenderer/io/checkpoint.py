"""Checkpoint / resume of progressive renders.

The reference's accumulation buffer IS its checkpoint: the running mean keyed
by `currentSample` stays valid at any interruption (`RayMarch3.glsl:542-554`,
Escape-to-cancel `Program.cpp:188-194`).  We persist the resumable triple
`(accum, n_samples, seed)` plus the render config, as a single .npz —
restartable on any host/chip count because the RNG is counter-based
(no generator state to save).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import NamedTuple, Optional

import numpy as np

from raymarchrenderer.render.config import RenderConfig


class RenderState(NamedTuple):
    accum: np.ndarray   # (H, W, 3) float32 linear running mean
    n: float            # samples accumulated so far
    cfg: RenderConfig
    scene_digest: Optional[str] = None  # identity of the scene that produced it


class SceneMismatchError(RuntimeError):
    """Resuming a checkpoint against a different scene than produced it —
    continuing would silently blend two scenes' images into one buffer."""


def scene_digest(scene, params) -> str:
    """Stable identity of (scene structure, parameter values).

    `repr(scene)` covers the static structure (frozen dataclass, `_init`
    excluded from repr); the flattened param leaves cover the values.  Two
    renders accumulate compatibly iff both match."""
    import jax

    h = hashlib.sha256(repr(scene).encode())
    leaves, treedef = jax.tree.flatten(params)
    h.update(repr(treedef).encode())
    for leaf in leaves:
        a = np.asarray(leaf)
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def save_checkpoint(path: str, accum, n: float, cfg: RenderConfig,
                    scene_digest: Optional[str] = None) -> None:
    arrays = dict(
        accum=np.asarray(accum, np.float32),
        n=np.float64(n),
        config=np.frombuffer(cfg.to_json().encode(), dtype=np.uint8))
    if scene_digest is not None:
        arrays["scene_digest"] = np.frombuffer(
            scene_digest.encode(), dtype=np.uint8)
    # write through a file object: np.savez_compressed(str_path) silently
    # appends ".npz", so `--checkpoint render.ckpt` would save to
    # render.ckpt.npz and `--resume` (which stats the exact path) would
    # never find it
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)


def load_checkpoint(path: str,
                    expect_scene_digest: Optional[str] = None) -> RenderState:
    """Load a checkpoint; when both the file and the caller carry a scene
    digest and they differ, refuse (`SceneMismatchError`) instead of
    resuming scene Y's accumulation buffer under scene X.  Digest-less
    checkpoints (older files) load without the check."""
    with np.load(path) as z:
        cfg = RenderConfig.from_json(bytes(z["config"].tobytes()).decode())
        digest = (bytes(z["scene_digest"].tobytes()).decode()
                  if "scene_digest" in z else None)
        if (expect_scene_digest is not None and digest is not None
                and digest != expect_scene_digest):
            raise SceneMismatchError(
                f"checkpoint {path} was produced by a different scene "
                f"(digest {digest[:12]}… != expected "
                f"{expect_scene_digest[:12]}…); refusing to blend two "
                f"scenes into one accumulation buffer")
        return RenderState(z["accum"], float(z["n"]), cfg, digest)
