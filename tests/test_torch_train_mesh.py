"""wax_tpu_torch's trainer on device meshes against wax_tpu's on the 8-device CPU mesh.

The port's meshes are eight logical CPU devices (`["cpu"] * 8`), laid out as JAX's are
on its eight virtual CPU devices (tests/conftest.py): data 8, data 4 x tp 2, slice 2 x
data 2 x tp 2, and data 1 x tp 8, where each of the 4 heads of the small config spans
two devices. Both trainers start from one flax init of `tests/test_torch_train.py`'s
small config in f32 and train on its batch, and are held to that file's bounds: the
loss at step 0 within rtol 1e-6, every leaf's gradient within rtol 1e-4 / atol 1e-7,
3 steps' losses within rtol 1e-5, the leaves after them within atol 1e-6 (the
attention key biases, whose gradient is rounding noise, within the learning rate a
step more). Also: the tp layout leaf for leaf against JAX's `param_partition_spec`
and its placed shards, checkpoints resuming across meshes and packages, and the
ValueError of a batch the data shards do not divide.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from tests.test_torch_train import LR, NOISE_LEAVES, SMALL, STEPS, setup  # noqa: F401  (setup: a fixture)
from wax_tpu.embed.minilm import MiniLMConfig as JaxConfig
from wax_tpu.embed.minilm import MiniLMEncoder as JaxEncoder
from wax_tpu.embed.minilm import param_partition_spec as jax_spec
from wax_tpu.parallel import mesh as jmesh
from wax_tpu.parallel.train import Trainer as JaxTrainer
from wax_tpu.parallel.train import contrastive_loss as jax_loss
from wax_tpu.text.wordpiece import WordPieceTokenizer
from wax_tpu_torch.embed import minilm as tm
from wax_tpu_torch.parallel import mesh as tmesh
from wax_tpu_torch.parallel.train import Trainer

CPU8 = ["cpu"] * 8
MESHES = {
    "data8": (lambda: jmesh.make_mesh(8), lambda: tmesh.data_mesh(CPU8)),
    "data4_tp2": (lambda: jmesh.make_mesh(8, tp=2), lambda: tmesh.make_mesh(CPU8, tp=2)),
    "slice2_data2_tp2": (lambda: jmesh.make_two_level_mesh(2, tp=2),
                         lambda: tmesh.make_two_level_mesh(2, tp=2, devices=CPU8)),
    "data1_tp8": (lambda: jmesh.make_mesh(8, tp=8), lambda: tmesh.make_mesh(CPU8, tp=8)),
}


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(params, mesh, lr=LR, cfg=SMALL):
    trainer = Trainer(tm.MiniLMEncoder(tm.MiniLMConfig(**cfg), dtype=torch.float32), mesh, learning_rate=lr)
    return trainer, trainer.init_state(tm.params_from_flax(_numpy(params)))


def _run(trainer, state, batch, steps):
    losses = []
    for _ in range(steps):
        state, loss = trainer.step(state, batch)
        losses.append(float(loss))
    return state, losses


@pytest.fixture(scope="module")
def jax_trainers(setup):  # noqa: F811
    """JAX's trainer on each mesh, made once: each compiles its step on first use."""
    model = setup[0]
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = JaxTrainer(model, MESHES[name][0](), learning_rate=LR)
        return cache[name]

    return get


@pytest.fixture(scope="module")
def jax_grads(setup):  # noqa: F811
    """JAX's loss and gradient at the init: the function's own, the same on any mesh."""
    model, params, batch = setup
    grad = jax.jit(lambda p, b: jax.value_and_grad(jax_loss)(p, model, b))
    loss, grads = grad(params, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), tm.params_from_flax(_numpy(grads))


@pytest.fixture(scope="module", params=list(MESHES))
def runs(request, setup, jax_trainers):  # noqa: F811
    """Each package on one mesh from the same init: 3 steps; the port's loss and
    gradients at the init."""
    _, params, batch = setup
    jt = jax_trainers(request.param)
    js, jl = _run(jt, jt.init_state(params), batch, STEPS)
    tt, ts = _port(params, MESHES[request.param][1]())
    tl0, tg = tt.loss_and_grads(ts.params, batch)
    ts, tl = _run(tt, ts, batch, STEPS)
    return {"jax": (jl, js), "port": (float(tl0), tg, tl, ts)}


def test_loss_at_step_zero(runs, jax_grads):
    jl, _ = runs["jax"]
    tl0, _, tl, _ = runs["port"]
    np.testing.assert_allclose(tl0, jl[0], rtol=1e-6)
    np.testing.assert_allclose(tl0, jax_grads[0], rtol=1e-6)
    assert tl[0] == tl0


def test_gradients_agree(runs, jax_grads):
    _, jg = jax_grads
    _, tg, _, _ = runs["port"]
    assert set(tg) == set(jg)
    for n in tg:
        np.testing.assert_allclose(tg[n].numpy(), jg[n].numpy(), rtol=1e-4, atol=1e-7, err_msg=n)
    for n in NOISE_LEAVES:  # zero in exact arithmetic: both sides are rounding noise
        assert float(jg[n].abs().max()) < 1e-7 and float(tg[n].abs().max()) < 1e-7


def test_three_steps_agree(runs):
    jl, js = runs["jax"]
    _, _, tl, ts = runs["port"]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    assert int(ts.step) == int(js.step) == STEPS and int(ts.opt_state.count) == STEPS
    jp = tm.params_from_flax(_numpy(js.params))
    for n, p in ts.params.items():
        atol = 1e-6 + (2 * STEPS * LR if n in NOISE_LEAVES else 0.0)
        np.testing.assert_allclose(p.numpy(), jp[n].numpy(), rtol=0, atol=atol, err_msg=n)


def test_partition_spec_matches_jax_at_full_width():
    """All 101 leaves of MiniLMConfig()'s params, under `flax_leaf`'s names."""
    shapes = jax.eval_shape(lambda: JaxEncoder(JaxConfig()).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
                                                                 jnp.ones((1, 8), jnp.int32))["params"])
    flat, _ = jax.tree_util.tree_flatten_with_path(jax_spec(shapes), is_leaf=lambda x: isinstance(x, PartitionSpec))
    theirs = {tuple(k.key for k in path): tuple(spec) for path, spec in flat}
    ours = tm.param_partition_spec(tm.MiniLMEncoder(tm.MiniLMConfig()).state_dict())
    assert len(ours) == len(theirs) == 101
    assert {tm.flax_leaf(n)[0]: spec for n, spec in ours.items()} == theirs
    split = {n: tm.tp_split_dim(n, spec) for n, spec in ours.items()}
    assert split["layer_0.attention.query.weight"] == split["layer_5.intermediate.weight"] == 0
    assert split["layer_0.attention.out.weight"] == split["layer_5.output.weight"] == 1
    assert split["layer_0.attention.query.bias"] is None and split["tok_emb.weight"] is None


def test_device_slices_are_jax_shards(setup):  # noqa: F811
    """On data 4 x tp 2, each device's slice of a split leaf is the shard JAX's
    `init_state` places on the device at the same mesh position."""
    model, params, _ = setup
    jt = JaxTrainer(model, jmesh.make_mesh(8, tp=2), learning_rate=LR)
    placed = jt.init_state(params).params
    tt, ts = _port(params, tmesh.make_mesh(CPU8, tp=2))
    pieces = tt._pieces(ts.params)
    position = {d: idx for idx, d in np.ndenumerate(jt.mesh.devices)}
    checked = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(placed)[0]:
        name = next(n for n in ts.params if tm.flax_leaf(n)[0] == tuple(k.key for k in path))
        dim = tt.split[name]
        if dim is None or leaf.ndim != 2:
            continue
        for shard in leaf.addressable_shards:
            s, r = position[shard.device]
            np.testing.assert_array_equal(pieces[s][r][name].detach().numpy(), np.asarray(shard.data).T, err_msg=name)
            checked += 1
    assert checked == 8 * 6 * SMALL["layers"]  # q/k/v/out/intermediate/output kernels on 8 devices


def test_batch_the_data_shards_do_not_divide_raises(setup):  # noqa: F811
    model, params, batch = setup
    twelve = {k: v[:12] for k, v in batch.items()}
    with pytest.raises(ValueError):
        JaxTrainer(model, jmesh.make_mesh(8), learning_rate=LR).shard_batch(twelve)
    tt, ts = _port(params, tmesh.data_mesh(CPU8))
    with pytest.raises(ValueError, match="12 rows do not split over 8 shards"):
        tt.step(ts, twelve)


def test_tp_must_divide_the_split_leaves(setup):  # noqa: F811
    _, params, _ = setup
    with pytest.raises(ValueError, match="tp=3 does not divide"):
        _port(params, tmesh.make_mesh(["cpu"] * 3, tp=3))


# ------------------------------------------------------------------ checkpoints


@pytest.fixture(scope="module")
def resume_case():
    """tests/test_parallel.py's resume case: its config (vocab 500), init (key 1),
    batch of 8 and learning rate 1e-3."""
    cfg = dict(hidden=64, layers=2, heads=4, intermediate=128, vocab_size=500, max_positions=64)
    model = JaxEncoder(JaxConfig(**cfg), dtype=jnp.float32)
    ids = jnp.zeros((1, 8), jnp.int32)
    params = model.init(jax.random.PRNGKey(1), ids, jnp.ones_like(ids))["params"]
    tok = WordPieceTokenizer(vocab_size=500, max_len=16)
    q_ids, q_mask = tok.encode_batch([f"q {i}" for i in range(8)], 16)
    d_ids, d_mask = tok.encode_batch([f"doc body {i}" for i in range(8)], 16)
    length = max(q_ids.shape[1], d_ids.shape[1])
    pad = lambda a: np.pad(a, ((0, 0), (0, length - a.shape[1])))  # noqa: E731
    return cfg, model, params, {"q_ids": pad(q_ids), "q_mask": pad(q_mask), "d_ids": pad(d_ids), "d_mask": pad(d_mask)}


def test_resume_on_another_mesh(resume_case, tmp_path):
    """Saved on data 4 x tp 2 after one step, resumed on data 4 x tp 1: the next two
    losses as the uninterrupted run's (JAX's test_checkpoint_resume_bitwise)."""
    cfg, _, params, batch = resume_case
    t1, s = _port(params, tmesh.make_mesh(CPU8, tp=2), lr=1e-3, cfg=cfg)
    s, _ = _run(t1, s, batch, 1)
    t1.save_checkpoint(s, tmp_path / "ck.npz")
    _, cont = _run(t1, s, batch, 2)
    t2, template = _port(params, tmesh.make_mesh(["cpu"] * 4, tp=1), lr=1e-3, cfg=cfg)
    restored = t2.load_checkpoint(template, tmp_path / "ck.npz")
    assert int(restored.step) == 1
    _, resumed = _run(t2, restored, batch, 2)
    np.testing.assert_allclose(resumed, cont, rtol=1e-5)


def test_checkpoints_cross_packages_from_tp_meshes(setup, jax_trainers, tmp_path):  # noqa: F811
    """A port file from data 4 x tp 2 resumes in JAX's trainer on make_mesh(4); a JAX
    file from make_mesh(8, tp=2) resumes in the port's on data 4 x tp 2; both give
    JAX's uninterrupted losses."""
    model, params, batch = setup
    jt = jax_trainers("data4_tp2")
    js, _ = _run(jt, jt.init_state(params), batch, 1)
    jt.save_checkpoint(js, tmp_path / "jax.npz")
    _, cont = _run(jt, js, batch, 2)
    tt, ts = _port(params, tmesh.make_mesh(CPU8, tp=2))
    ts, _ = _run(tt, ts, batch, 1)
    tt.save_checkpoint(ts, tmp_path / "port.npz")
    j4 = JaxTrainer(model, jmesh.make_mesh(4), learning_rate=LR)
    in_jax = j4.load_checkpoint(j4.init_state(params), tmp_path / "port.npz")
    assert int(in_jax.step) == 1
    _, jax_resumed = _run(j4, in_jax, batch, 2)
    in_port = tt.load_checkpoint(tt.init_state(tm.params_from_flax(_numpy(params))), tmp_path / "jax.npz")
    _, port_resumed = _run(tt, in_port, batch, 2)
    np.testing.assert_allclose(jax_resumed, cont, rtol=1e-5)
    np.testing.assert_allclose(port_resumed, cont, rtol=1e-5)


@pytest.mark.parametrize("mesh", ["data4_tp2", "slice2_data2_tp2"])
def test_same_mesh_resume_is_bitwise(resume_case, tmp_path, mesh):
    cfg, _, params, batch = resume_case
    tt, ts = _port(params, MESHES[mesh][1](), lr=1e-3, cfg=cfg)
    ts, _ = _run(tt, ts, batch, 2)
    tt.save_checkpoint(ts, tmp_path / "ck.npz")
    with np.load(tmp_path / "ck.npz") as data:
        assert len(data.files) == 3 * (5 + 16 * cfg["layers"]) + 2
    ts, cont = _run(tt, ts, batch, 2)
    restored = tt.load_checkpoint(tt.init_state(tm.params_from_flax(_numpy(params))), tmp_path / "ck.npz")
    restored, resumed = _run(tt, restored, batch, 2)
    assert resumed == cont
    for n in ts.params:
        assert torch.equal(ts.params[n], restored.params[n]), n
