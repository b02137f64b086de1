"""Host-side constant hygiene for jit closures.

Intersector factories close over scene-derived arrays (triangle SoA rows,
packed cluster matrices, BVH nodes).  If those are *device* arrays, every
``jit`` trace that captures them embeds them as MLIR constants — and JAX
fetches each one back to the host (``jax._src.array._value``) while lowering,
a device->host round trip per constant that counts as compile time.

The rule this module enforces: **constants captured by jitted code must be
host (numpy) arrays**.  Lowering then serializes them from host memory with
zero device round-trips, and XLA uploads them once at executable load.

Tracers pass through untouched so the same factory code serves the
differentiable path (intersectors rebuilt inside a traced loss, where scene
fields are tracers and must stay in-graph).
"""

from __future__ import annotations

import jax
import numpy as np


def is_traced(*pytrees) -> bool:
    """True iff any leaf of any argument is a JAX tracer."""
    return any(
        isinstance(leaf, jax.core.Tracer)
        for tree in pytrees
        for leaf in jax.tree_util.tree_leaves(tree)
    )


def host_const(x):
    """numpy copy of a concrete array (one batched D2H if on device);
    tracers pass through unchanged."""
    if isinstance(x, jax.core.Tracer):
        return x
    if isinstance(x, np.ndarray):
        return x
    return jax.device_get(x)


def host_tree(tree):
    """``jax.device_get`` a whole pytree (e.g. SceneArrays) to numpy leaves.
    Must not contain tracers — check :func:`is_traced` first."""
    return jax.device_get(tree)
