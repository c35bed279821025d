"""Shared helpers of the tests that hold the PyTorch port
(``curvecloudnet_tpu_torch``) against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages; JAX
variables are initialized under ``jax.jit`` and their BatchNorm parameters
and running statistics perturbed so that every eval BN fold is exercised.
"""

from __future__ import annotations

import numpy as np
import torch

from curvecloudnet_tpu.data.synthetic import synthetic_lidar_batch


def lidar(n: int, batch: int = 2, seed: int = 0, feat: int | None = None):
    """Synthetic lidar sweeps (numpy): pos, x, curve_id, valid.  ``feat``
    replaces the reflectance channel with that many N(0, 1) channels."""
    rng = np.random.default_rng(seed)
    pos, x, cid, valid, _ = synthetic_lidar_batch(rng, batch, n)
    if feat is not None:
        x = rng.normal(size=(batch, n, feat)).astype(np.float32)
    return pos, x, cid, valid


def to_torch(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def perturb_variables(variables, seed: int = 1):
    """numpy copy of a flax variables dict with BN scale/bias shifted and
    running statistics drawn: mean N(0, 0.1), var U(0.5, 1.5)."""
    import jax

    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(np.asarray, dict(variables))

    def walk(node, collection, leaf_name=None):
        if isinstance(node, dict):
            return {k: walk(v, collection, k) for k, v in node.items()}
        if collection == "batch_stats":
            if leaf_name == "var":
                return (0.5 + rng.random(node.shape)).astype(np.float32)
            return (0.1 * rng.normal(size=node.shape)).astype(np.float32)
        if leaf_name in ("scale", "bias") and node.ndim == 1:
            return (node + 0.1 * rng.normal(size=node.shape)).astype(np.float32)
        return node

    return {c: walk(dict(tree[c]), c) for c in tree}


def jax_init(module, *args, seed: int = 1, **kwargs):
    """Jitted flax init of ``module`` on ``args`` -> perturbed numpy vars."""
    import jax

    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda *a: module.init(
        {"params": key, "dropout": key}, *a, train=False, **kwargs))(*args)
    return perturb_variables(variables, seed)


def load_step(port_module, variables, step, index: int = 0):
    """Load a standalone JAX step module's variables into the port's step
    module through ``from_jax_variables``."""
    from types import SimpleNamespace

    from curvecloudnet_tpu_torch.checkpoint import from_jax_variables

    name = f"step_{index}_{step.name}"
    sd = from_jax_variables({name: variables["params"]},
                            {name: variables.get("batch_stats", {})},
                            SimpleNamespace(steps=(step,)))
    prefix = f"steps.{index}."
    port_module.load_state_dict(
        {k[len(prefix):]: v for k, v in sd.items()}, strict=True)
    return port_module.eval()


def assert_same_neighbors(idx_a, idx_b, q_pos, p_pos, q_valid, d2_tol: float,
                          radius=None, capped: bool = False):
    """Neighbor tables agree as sets per query, up to distance ties: a point
    in one table but not the other must lie within ``d2_tol`` (squared
    distance) of the boundary the tables cut at (the k-th distance, or the
    radius; with ``capped``, a radius search whose k slots both tables
    fill may cut at the k-th distance too).  Distances are recomputed
    exactly in float64."""
    idx_a, idx_b = np.asarray(idx_a), np.asarray(idx_b)
    q_pos, p_pos = q_pos.astype(np.float64), p_pos.astype(np.float64)
    assert idx_a.shape == idx_b.shape
    for b, q in zip(*np.nonzero(q_valid)):
        a = set(idx_a[b, q][idx_a[b, q] >= 0].tolist())
        c = set(idx_b[b, q][idx_b[b, q] >= 0].tolist())
        if a == c:
            continue
        assert radius is not None or len(a) == len(c), (b, q, a, c)
        d2 = lambda j: float(((q_pos[b, q] - p_pos[b, j]) ** 2).sum())  # noqa
        cuts = [max(d2(j) for j in a | c)] if radius is None else [radius ** 2]
        if capped and radius is not None and len(a) == len(c) == \
                idx_a.shape[-1]:
            cuts.append(max(d2(j) for j in a | c))
        for j in a ^ c:
            assert min(abs(d2(j) - cut) for cut in cuts) <= d2_tol, (
                b, q, j, d2(j), cuts)


def direct_knn(query, points, q_valid, p_valid, k, radius=None, **_):
    """An exact JAX kNN on direct differences, a stand-in for the JAX
    package's ``ops.neighbors.knn``: its CPU search expands |q|^2 + |p|^2 -
    2 q.p, which can drop a point that lies within rounding of the radius
    or reorder near-ties at the k-th distance (``assert_same_neighbors``
    bounds that); this search decides as the port does, so module and
    model outputs can be held at float tolerance."""
    import jax
    import jax.numpy as jnp

    d2 = jnp.sum((query[:, :, None, :] - points[:, None, :, :]) ** 2, -1)
    d2 = jnp.where(p_valid[:, None, :], d2, 1e30)
    neg, idx = jax.lax.top_k(-d2, min(k, points.shape[1]))
    good = (-neg < 1e30) & q_valid[:, :, None]
    if radius is not None:
        good = good & (-neg <= radius * radius)
    return (jnp.where(good, idx, -1).astype(jnp.int32),
            jnp.where(good, jnp.sqrt(-neg), 1e30))


def expansion_d2_tol(q_pos, p_pos) -> float:
    """Rounding bound of |q|^2 + |p|^2 - 2 q.p in f32 (the JAX CPU search):
    a few ulps of the largest squared norm."""
    s = float((q_pos.astype(np.float64) ** 2).sum(-1).max()
              + (p_pos.astype(np.float64) ** 2).sum(-1).max())
    return 8 * np.finfo(np.float32).eps * s
