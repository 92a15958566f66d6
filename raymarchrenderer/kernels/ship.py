"""Ship a parameter pytree into a Pallas kernel as scalar rows.

Scene constants, band tables, camera corners and launch scalars are a few
dozen numbers.  A GPU kernel reads them best as scalars held in registers,
and Triton only lowers in-kernel arrays whose sizes are powers of two, so
a `(3,)` leaf cannot travel as a vector.  `pack` flattens every leaf into
ONE f32 row (and one i32 row when integer leaves exist), each padded to a
power of two; inside the kernel `unpack` rebuilds the pytree from scalar
loads.  Non-scalar leaves come back as numpy object arrays of scalars, so
the shared scene code indexes them (`a[0]`, `pos[i]`, `kind[i]`) exactly
as it indexes the plain arrays of the oracle.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


def next_pow2(n: int) -> int:
    """Smallest power of two >= max(n, 1)."""
    return 1 << max(0, int(n) - 1).bit_length()


class Layout(NamedTuple):
    """Static description of a packed tree (hashable: closes over kernels).

    `leaves` holds (shape, dtype name, row "f"/"i", offset) per leaf."""
    treedef: object
    leaves: tuple


def _is_float(dtype) -> bool:
    return jnp.issubdtype(dtype, jnp.floating)


def pack(tree):
    """(rows, layout): `rows` is `[f32 (1, Nf)]` plus `[i32 (1, Ni)]` when
    the tree has integer or boolean leaves; Nf, Ni are powers of two."""
    leaves, treedef = jax.tree.flatten(tree)
    f_parts, i_parts, meta = [], [], []
    f_off = i_off = 0
    for leaf in leaves:
        a = jnp.asarray(leaf)
        flat = a.reshape(-1)
        if _is_float(a.dtype):
            meta.append((a.shape, a.dtype.name, "f", f_off))
            f_parts.append(flat.astype(jnp.float32))
            f_off += a.size
        else:
            # uint32 ids wrap to the same bits; unpack converts back
            meta.append((a.shape, a.dtype.name, "i", i_off))
            i_parts.append(flat.astype(jnp.int32))
            i_off += a.size
    rows = [_row(f_parts, jnp.float32)]
    if i_parts:
        rows.append(_row(i_parts, jnp.int32))
    return rows, Layout(treedef, tuple(meta))


def _row(parts, dtype):
    flat = (jnp.concatenate(parts) if parts
            else jnp.zeros((0,), dtype))
    n = flat.shape[0]
    return jnp.pad(flat, (0, next_pow2(n) - n)).reshape(1, -1)


def unpack(layout: Layout, f_ref, i_ref=None):
    """Rebuild the packed tree inside a kernel from scalar loads."""
    out = []
    for shape, dtype, row, off in layout.leaves:
        ref = f_ref if row == "f" else i_ref
        n = int(np.prod(shape, dtype=np.int64))
        vals = [_restore(ref[0, off + k], dtype) for k in range(n)]
        if shape == ():
            out.append(vals[0])
            continue
        arr = np.empty(n, dtype=object)
        for k, v in enumerate(vals):
            arr[k] = v
        out.append(arr.reshape(shape))
    return jax.tree.unflatten(layout.treedef, out)


def _restore(v, dtype: str):
    if dtype == "bool":
        return v != 0
    if dtype in ("float32", "int32"):
        return v
    return v.astype(jnp.dtype(dtype))
