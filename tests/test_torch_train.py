"""wax_tpu_torch's contrastive trainer against wax_tpu's on the same flax params.

JAX's `Trainer` runs on an 8-device (data 4 x tp 2) CPU mesh, the port's on
`device="cpu"`, both from one flax init of the tests' small MiniLM config in f32, on
the batch of `tests/test_parallel.py` (16 query/document pairs of WordPiece ids).
Checkpoints cross both ways: each package's file resumes in the other.

The learning rate is the trainers' default, 2e-5. The attention key biases are held
apart from the other leaves after the steps: softmax is invariant to a constant added
to every score of a row, so their gradient is zero in exact arithmetic and each
package's gradient is rounding noise (a few 1e-9 here, inside the gradient tolerance
below). Adam divides a gradient by its own running norm, so the two noises move the
two copies of those biases by up to the learning rate a step, apart from each other;
they are held to that bound, every other leaf to atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wax_tpu.embed.minilm import MiniLMConfig as JaxConfig, MiniLMEncoder as JaxEncoder
from wax_tpu.parallel.mesh import make_mesh
from wax_tpu.parallel.train import Trainer as JaxTrainer, contrastive_loss as jax_loss
from wax_tpu.text.wordpiece import WordPieceTokenizer
from wax_tpu_torch.embed import minilm as tm
from wax_tpu_torch.parallel.mesh import Mesh, data_mesh
from wax_tpu_torch.parallel.train import Trainer, contrastive_loss

SMALL = dict(hidden=64, layers=2, heads=4, intermediate=128, vocab_size=1000, max_positions=64)
LR = 2e-5
STEPS = 3
NOISE_LEAVES = ("layer_0.attention.key.bias", "layer_1.attention.key.bias")


@pytest.fixture(scope="module")
def setup():
    model = JaxEncoder(JaxConfig(**SMALL), dtype=jnp.float32)
    ids = jnp.zeros((1, 8), jnp.int32)
    params = model.init(jax.random.PRNGKey(0), ids, jnp.ones_like(ids))["params"]
    tok = WordPieceTokenizer(vocab_size=1000, max_len=32)
    q_ids, q_mask = tok.encode_batch([f"topic {i % 4} question {i}" for i in range(16)], 32)
    d_ids, d_mask = tok.encode_batch([f"document number {i} about topic {i % 4}" for i in range(16)], 32)
    length = max(q_ids.shape[1], d_ids.shape[1])
    pad = lambda a: np.pad(a, ((0, 0), (0, length - a.shape[1])))  # noqa: E731
    batch = {"q_ids": pad(q_ids), "q_mask": pad(q_mask), "d_ids": pad(d_ids), "d_mask": pad(d_mask)}
    return model, params, batch


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(params):
    trainer = Trainer(tm.MiniLMEncoder(tm.MiniLMConfig(**SMALL), dtype=torch.float32), data_mesh("cpu"),
                      learning_rate=LR)
    return trainer, trainer.init_state(tm.params_from_flax(_numpy(params)))


def _jax(model, params, n_dev=8, tp=2):
    trainer = JaxTrainer(model, make_mesh(n_dev, tp=tp), learning_rate=LR)
    return trainer, trainer.init_state(params)


def _run(trainer, state, batch, steps):
    losses = []
    for _ in range(steps):
        state, loss = trainer.step(state, batch)
        losses.append(float(loss))
    return state, losses


def test_loss_at_step_zero(setup):
    model, params, batch = setup
    jl = float(jax_loss(params, model, {k: jnp.asarray(v) for k, v in batch.items()}))
    trainer, state = _port(params)
    tl = float(contrastive_loss(state.params, trainer.model, trainer.shard_batch(batch)[0]))
    np.testing.assert_allclose(tl, jl, rtol=1e-6)


def test_gradients_agree(setup):
    model, params, batch = setup
    jg = tm.params_from_flax(_numpy(jax.grad(jax_loss)(params, model, {k: jnp.asarray(v) for k, v in batch.items()})))
    trainer, state = _port(params)
    names = list(state.params)
    leaves = [state.params[n].detach().requires_grad_() for n in names]
    loss = contrastive_loss(dict(zip(names, leaves)), trainer.model, trainer.shard_batch(batch)[0])
    tg = dict(zip(names, torch.autograd.grad(loss, leaves)))
    assert set(tg) == set(jg)
    for n in names:
        np.testing.assert_allclose(tg[n].numpy(), jg[n].numpy(), rtol=1e-4, atol=1e-7, err_msg=n)
    for n in NOISE_LEAVES:  # zero in exact arithmetic: both sides are rounding noise
        assert float(jg[n].abs().max()) < 1e-7 and float(tg[n].abs().max()) < 1e-7


def _params_agree(port_state, jax_state, steps):
    jp = tm.params_from_flax(_numpy(jax_state.params))
    for n, p in port_state.params.items():
        atol = 1e-6 + (2 * steps * LR if n in NOISE_LEAVES else 0.0)
        np.testing.assert_allclose(p.numpy(), jp[n].numpy(), rtol=0, atol=atol, err_msg=n)


def test_three_steps_agree(setup):
    model, params, batch = setup
    jt, js = _jax(model, params)
    js, jl = _run(jt, js, batch, STEPS)
    tt, ts = _port(params)
    ts, tl = _run(tt, ts, batch, STEPS)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert jl[-1] < jl[0] and tl[-1] < tl[0]
    assert int(ts.step) == int(js.step) == STEPS
    assert int(ts.opt_state.count) == int(js.opt_state[0].count) == STEPS
    _params_agree(ts, js, STEPS)


def test_optimizer_state_agrees(setup):
    """mu and nu after the steps, leaf by leaf, against optax's: mu, a weighted sum of
    gradients, at the gradients' tolerance; nu = 0.001 * g^2 + ..., whose gap is about
    0.002 |g| times the gradients' gap, at atol 1e-12."""
    model, params, batch = setup
    jt, js = _jax(model, params)
    js, _ = _run(jt, js, batch, 2)
    tt, ts = _port(params)
    ts, _ = _run(tt, ts, batch, 2)
    adam = js.opt_state[0]
    for ours, theirs, atol in ((ts.opt_state.mu, adam.mu, 1e-7), (ts.opt_state.nu, adam.nu, 1e-12)):
        ref = tm.params_from_flax(_numpy(theirs))
        for n, t in ours.items():
            np.testing.assert_allclose(t.numpy(), ref[n].numpy(), rtol=1e-4, atol=atol, err_msg=n)


def test_checkpoint_layout_is_jax_tree_order(setup, tmp_path):
    """The port's file has JAX's leaves in `tree_flatten(TrainState)` order: shapes,
    dtypes and values of the JAX state it was loaded from."""
    model, params, batch = setup
    jt, js = _jax(model, params)
    js, _ = _run(jt, js, batch, 1)
    jt.save_checkpoint(js, tmp_path / "jax.npz")
    tt, template = _port(params)
    restored = tt.load_checkpoint(template, tmp_path / "jax.npz")
    tt.save_checkpoint(restored, tmp_path / "port.npz")
    flat, _ = jax.tree_util.tree_flatten(js)
    assert len(flat) == 3 * (5 + 16 * SMALL["layers"]) + 2 == 113
    with np.load(tmp_path / "port.npz") as ours, np.load(tmp_path / "jax.npz") as theirs:
        assert sorted(ours.files) == sorted(theirs.files) == sorted(f"leaf_{i}" for i in range(len(flat)))
        for i, leaf in enumerate(flat):
            a, b = ours[f"leaf_{i}"], theirs[f"leaf_{i}"]
            assert a.shape == b.shape == leaf.shape and a.dtype == b.dtype == leaf.dtype, i
            np.testing.assert_array_equal(a, b)


def test_jax_checkpoint_resumes_in_port(setup, tmp_path):
    model, params, batch = setup
    jt, js = _jax(model, params)
    js, _ = _run(jt, js, batch, 1)
    jt.save_checkpoint(js, tmp_path / "ck.npz")
    _, jl = _run(jt, js, batch, 2)
    tt, template = _port(params)
    restored = tt.load_checkpoint(template, tmp_path / "ck.npz")
    assert int(restored.step) == 1 and int(restored.opt_state.count) == 1
    _, tl = _run(tt, restored, batch, 2)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)


def test_port_checkpoint_resumes_in_jax(setup, tmp_path):
    model, params, batch = setup
    jt, js = _jax(model, params)
    js, _ = _run(jt, js, batch, 1)
    _, jl = _run(jt, js, batch, 2)
    tt, ts = _port(params)
    ts, _ = _run(tt, ts, batch, 1)
    tt.save_checkpoint(ts, tmp_path / "ck.npz")
    jt2, template = _jax(model, params, n_dev=4, tp=1)
    restored = jt2.load_checkpoint(template, tmp_path / "ck.npz")
    assert int(restored.step) == 1
    _, jl2 = _run(jt2, restored, batch, 2)
    np.testing.assert_allclose(jl2, jl, rtol=1e-5)


def test_port_resume_is_bitwise(setup, tmp_path):
    model, params, batch = setup
    tt, ts = _port(params)
    ts, _ = _run(tt, ts, batch, 2)
    tt.save_checkpoint(ts, tmp_path / "ck.npz")
    assert not (tmp_path / "ck.npz.tmp").exists()
    ts, cont = _run(tt, ts, batch, 3)
    restored = tt.load_checkpoint(tt.init_state(tm.params_from_flax(_numpy(params))), tmp_path / "ck.npz")
    restored, resumed = _run(tt, restored, batch, 3)
    assert resumed == cont
    for n in ts.params:
        assert torch.equal(ts.params[n], restored.params[n]), n


def test_init_state_copies_the_callers_params(setup):
    model, params, batch = setup
    sd = tm.params_from_flax(_numpy(params))
    before = {n: t.clone() for n, t in sd.items()}
    trainer = Trainer(tm.MiniLMEncoder(tm.MiniLMConfig(**SMALL), dtype=torch.float32), data_mesh("cpu"))
    _run(trainer, trainer.init_state(sd), batch, 1)
    assert all(torch.equal(sd[n], before[n]) for n in sd)


def test_params_to_flax_inverts_params_from_flax(setup):
    _, params, _ = setup
    tree = _numpy(params)
    back = tm.params_to_flax(tm.params_from_flax(tree))
    flat_a, tdef_a = jax.tree_util.tree_flatten(tree)
    flat_b, tdef_b = jax.tree_util.tree_flatten(back)
    assert tdef_a == tdef_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    sd = tm.params_from_flax(tree)
    again = tm.params_from_flax(tm.params_to_flax(sd))
    assert all(torch.equal(sd[n], again[n]) for n in sd)


def test_batch_that_shards_do_not_divide_raises(setup):
    """The trainer takes any mesh; the batch's rows must split evenly over its corpus
    shards, and the error names their count."""
    _, params, batch = setup
    trainer = Trainer(tm.MiniLMEncoder(tm.MiniLMConfig(**SMALL), dtype=torch.float32), Mesh(["cpu"] * 3))
    state = trainer.init_state(tm.params_from_flax(_numpy(params)))
    with pytest.raises(ValueError, match="16 rows do not split over 3 shards"):
        trainer.step(state, batch)


def test_full_width_checkpoint_has_305_leaves(tmp_path):
    """At MiniLMConfig()'s 6 layers the file holds 3 x 101 + 2 leaves, each of the
    JAX init's shape in JAX's order (the port's file is written from a zero state)."""
    cfg = JaxConfig()
    shapes = jax.eval_shape(lambda: JaxEncoder(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
                                                          jnp.ones((1, 8), jnp.int32))["params"])
    jax_leaves = jax.tree_util.tree_leaves(shapes)
    trainer = Trainer(tm.MiniLMEncoder(tm.MiniLMConfig()), data_mesh("cpu"))
    state = trainer.init_state({n: torch.zeros(t.shape) for n, t in trainer.model.state_dict().items()})
    trainer.save_checkpoint(state, tmp_path / "full.npz")
    with np.load(tmp_path / "full.npz") as data:
        assert len(data.files) == 305
        for i, leaf in enumerate(jax_leaves):
            for off in (0, 102, 203):  # params, mu, nu
                assert data[f"leaf_{i + off}"].shape == leaf.shape
        assert data["leaf_101"].dtype == data["leaf_304"].dtype == np.int32
