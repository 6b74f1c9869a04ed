"""wax_tpu_torch.ops.topk against wax_tpu.ops.topk on the same numpy inputs.

Inputs are integer-valued and full of ties, so every comparison is exact: values AND
indices must be equal, which pins the lowest-index tie-break (the JAX package gets it
from `lax.top_k` being stable; the port from a stable sort).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wax_tpu.ops import topk as jtopk
from wax_tpu_torch.ops import topk as ttopk


def _tied(rng, shape, hi=4):
    return rng.integers(0, hi, shape).astype(np.float32)


def _eq(jax_out, torch_out):
    for j, t in zip(jax_out, torch_out):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize("k", [1, 5, 64])
@pytest.mark.parametrize("masked", [False, True])
def test_masked_top_k(rng, k, masked):
    s = _tied(rng, (6, 64))
    mask = rng.random((6, 64)) < 0.6 if masked else None
    j = jtopk.masked_top_k(jnp.asarray(s), k, None if mask is None else jnp.asarray(mask))
    t = ttopk.masked_top_k(torch.from_numpy(s), k, None if mask is None else torch.from_numpy(mask))
    _eq(j, t)
    assert t[1].dtype == torch.int32


def test_masked_top_k_all_dead_slots(rng):
    s = _tied(rng, (3, 16))
    mask = np.zeros((3, 16), bool)
    mask[1, 3] = True
    j = jtopk.masked_top_k(jnp.asarray(s), 4, jnp.asarray(mask))
    t = ttopk.masked_top_k(torch.from_numpy(s), 4, torch.from_numpy(mask))
    _eq(j, t)
    assert (t[1][0] == -1).all() and t[1][1, 0] == 3 and (t[1][1, 1:] == -1).all()


@pytest.mark.parametrize("k", [1, 3, 8])
def test_merge_topk(rng, k):
    va, vb = _tied(rng, (5, 8)), _tied(rng, (5, 8))
    va[:, -2:] = jtopk.NEG_INF  # dead slots carry NEG_INF and id -1
    ia = rng.integers(0, 100, (5, 8)).astype(np.int32)
    ia[:, -2:] = -1
    ib = rng.integers(100, 200, (5, 8)).astype(np.int32)
    j = jtopk.merge_topk(*(jnp.asarray(x) for x in (va, ia, vb, ib)), k)
    t = ttopk.merge_topk(*(torch.from_numpy(x) for x in (va, ia, vb, ib)), k)
    _eq(j, t)


@pytest.mark.parametrize("n,k", [(1024, 3), (1024, 10), (2048, 5), (1000, 4)])
def test_blockmax_topk(rng, n, k):
    """Covers the chunk-pruned branch (n > 128k, n % 128 == 0) and the direct one."""
    s = _tied(rng, (4, n), hi=6)
    j = jtopk.blockmax_topk(jnp.asarray(s), k)
    t = ttopk.blockmax_topk(torch.from_numpy(s), k)
    _eq(j, t)


def test_topk_with_ids(rng):
    s = _tied(rng, (4, 32))
    ids = rng.integers(1000, 2000, 32).astype(np.int32)
    mask = rng.random((4, 32)) < 0.5
    j = jtopk.topk_with_ids(jnp.asarray(s), jnp.asarray(ids), 6, jnp.asarray(mask))
    t = ttopk.topk_with_ids(torch.from_numpy(s), torch.from_numpy(ids), 6, torch.from_numpy(mask))
    _eq(j, t)


def test_neg_inf_constant():
    assert ttopk.NEG_INF == jtopk.NEG_INF
