"""`sharded_bm25_topk` against wax_tpu's on a one-device mesh.

The stores of tests/test_torch_sharded_hybrid.py (2,048 documents, exact and at a
budget of 40 postings per term; its `built` fixture), in `any` and `all` modes, through
the plain merge harness ("candidates"), the kernel lanes ("candidates_pallas": K4 then
K3 on the budgeted store, K8 on the exact one; JAX's kernels in interpret mode) and
`auto`: frame ids equal, scores within rtol 1e-6. This test sits in a file of its own
so that pytest-xdist's `--dist loadfile` runs it beside the rest of that file.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_sharded_hybrid import BUDGET, N, _term_ids, built  # noqa: F401  (a fixture)
from wax_tpu.parallel import sharded_hybrid as jsh
from wax_tpu.parallel.mesh import data_mesh as jax_mesh
from wax_tpu_torch.parallel import sharded_hybrid as tsh
from wax_tpu_torch.parallel.mesh import data_mesh as torch_mesh


@pytest.mark.parametrize("mode", ["any", "all"])
@pytest.mark.parametrize("budget,backend", [(None, "candidates"), (BUDGET, "candidates"),
                                            (BUDGET, "candidates_pallas"), (BUDGET, "auto"),
                                            (None, "candidates_pallas")])
def test_sharded_bm25_topk_equal(built, mode, budget, backend):
    jl, tl = built[0][budget]
    jm = jax_mesh(1)
    js = jsh.shard_lex_index(jl, jm, N)
    ts = tsh.shard_lex_index(tl, torch_mesh("cpu"), N)
    tids = _term_ids(tl)
    for k in (5, 24):
        jv, jf = jsh.sharded_bm25_topk(jnp.asarray(tids), js, k, jm, mode=mode, backend=backend)
        tv, tf = tsh.sharded_bm25_topk(torch.from_numpy(tids), ts, k, torch_mesh("cpu"), mode=mode,
                                       backend=backend)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=0)
        if budget is None and backend == "candidates_pallas":
            # K8 sums a row in query-slot order, the TPU kernel in merge-network order:
            # the many duplicate documents here tie exactly in the port (lowest row
            # first) and up to an ulp apart in the JAX package
            deep = jsh.sharded_bm25_topk(jnp.asarray(tids), js, k + 64, jm, mode=mode, backend=backend)
            np.testing.assert_array_equal(tf.numpy(), _lowest_row_on_ties(*deep, k))
        else:
            np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert (tf.numpy() >= 0).any() and (tf.numpy()[5] == -1).all()


def _lowest_row_on_ties(vals, fids, k, rtol=1e-6):
    """The first k of a ranked list once scores within `rtol` of their neighbour are
    taken as one tie, broken by the lowest id (frame id == row in these stores)."""
    vals, fids = np.asarray(vals), np.asarray(fids)
    out = np.full((vals.shape[0], k), -1, np.int32)
    for i in range(vals.shape[0]):
        group, key = 0, []
        for j in range(vals.shape[1]):
            if fids[i, j] < 0:
                break
            if j and abs(vals[i, j] - vals[i, j - 1]) > rtol * abs(vals[i, j - 1]):
                group += 1
            key.append((group, fids[i, j]))
        ranked = [f for _, f in sorted(key)][:k]
        out[i, : len(ranked)] = ranked
    return out
