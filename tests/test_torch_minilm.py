"""wax_tpu_torch MiniLM encoder against wax_tpu's flax encoder on the same weights.

The flax params of a small config are converted with `params_from_flax`, so both
packages run the same weights on the same token ids; `load_hf_checkpoint` is held
against a HuggingFace BertModel built from config (offline), and the WordPiece copy
against the JAX package's tokenizer.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wax_tpu.embed import minilm as jm
from wax_tpu.text.wordpiece import WordPieceTokenizer as JaxTokenizer
from wax_tpu_torch.embed import minilm as tm
from wax_tpu_torch.text.wordpiece import WordPieceTokenizer as TorchTokenizer

SMALL = dict(vocab_size=500, hidden=64, layers=2, heads=4, intermediate=128, max_positions=64)


@pytest.fixture(scope="module")
def flax_params():
    model = jm.MiniLMEncoder(jm.MiniLMConfig(**SMALL), dtype=jnp.float32)
    ids = jnp.zeros((1, 8), jnp.int32)
    params = model.init(jax.random.PRNGKey(0), ids, jnp.ones_like(ids))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _inputs(seed=0, b=3, length=16):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 500, (b, length)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[0, 11:] = 0
    ids[0, 11:] = 0
    mask[2, 5:] = 0
    return ids, mask


def _both(flax_params, dtype_j, dtype_t):
    jmodel = jm.MiniLMEncoder(jm.MiniLMConfig(**SMALL), dtype=dtype_j)
    tmodel = tm.MiniLMEncoder(tm.MiniLMConfig(**SMALL), dtype=dtype_t)
    tmodel.load_state_dict(tm.params_from_flax(flax_params))
    return jmodel, tmodel.eval()


def _run(jmodel, tmodel, flax_params, ids, mask):
    jh = jmodel.apply({"params": flax_params}, jnp.asarray(ids), jnp.asarray(mask))
    jp = np.asarray(jm.mean_pool(jh, jnp.asarray(mask)))
    with torch.no_grad():
        th = tmodel(torch.from_numpy(ids), torch.from_numpy(mask))
        tp = tm.mean_pool(th, torch.from_numpy(mask)).numpy()
    return np.asarray(jh.astype(jnp.float32)), th.float().numpy(), jp, tp


def test_params_from_flax_covers_state_dict(flax_params):
    sd = tm.params_from_flax(flax_params)
    model = tm.MiniLMEncoder(tm.MiniLMConfig(**SMALL))
    assert set(sd) == set(model.state_dict())
    # Dense kernels [in, out] become weights [out, in]
    k = flax_params["layer_0"]["intermediate"]["kernel"]
    np.testing.assert_array_equal(sd["layer_0.intermediate.weight"].numpy(), k.T)


def test_f32_hidden_and_pooled_match(flax_params):
    jmodel, tmodel = _both(flax_params, jnp.float32, torch.float32)
    ids, mask = _inputs()
    jh, th, jp, tp = _run(jmodel, tmodel, flax_params, ids, mask)
    np.testing.assert_allclose(th, jh, atol=2e-5, rtol=0)
    np.testing.assert_allclose(tp, jp, atol=2e-5, rtol=0)


def test_bf16_pooled_cosine(flax_params):
    jmodel, tmodel = _both(flax_params, jnp.bfloat16, torch.bfloat16)
    ids, mask = _inputs(seed=1, b=4, length=32)
    _, _, jp, tp = _run(jmodel, tmodel, flax_params, ids, mask)
    cos = (jp * tp).sum(axis=1)  # both unit norm
    assert cos.min() >= 0.999, cos


def test_load_hf_checkpoint_matches_bert(tmp_path):
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.BertConfig(
        vocab_size=500, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=128, max_position_embeddings=64, type_vocab_size=2,
        hidden_act="gelu", hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
    )
    torch.manual_seed(0)
    hf = transformers.BertModel(hf_cfg, add_pooling_layer=False).eval()
    torch.save(hf.state_dict(), tmp_path / "pytorch_model.bin")
    cfg = tm.MiniLMConfig(**SMALL)
    model = tm.MiniLMEncoder(cfg, dtype=torch.float32)
    model.load_state_dict(tm.load_hf_checkpoint(tmp_path, cfg))
    ids, mask = _inputs(seed=2)
    with torch.no_grad():
        ref = hf(input_ids=torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask)).last_hidden_state
        ours = model.eval()(torch.from_numpy(ids), torch.from_numpy(mask))
    m = torch.from_numpy(mask).bool()
    torch.testing.assert_close(ours[m], ref[m], atol=2e-4, rtol=2e-3)


STRINGS = [
    "The quick brown fox jumps over the lazy dog.",
    "hello,world!! 42 times -- ok?",
    "Café déjà vu: naïve façade, Ångström, São Paulo",
    "Straße ﬁne Œuvre",
    "東京タワーは高い。北京欢迎你",
    "ＦＵＬＬ－ＷＩＤＴＨ　ｔｅｘｔ　１２３",
    "tabs\tand\nnewlines\r\x00control\x07chars",
    "internationalization antidisestablishmentarianism",
    "",
]


@pytest.mark.parametrize("with_vocab", [False, True])
def test_wordpiece_copy_ids_identical(tmp_path, with_vocab):
    vocab = None
    if with_vocab:
        vocab = tmp_path / "vocab.txt"
        pieces = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + ["[UNK]", "[CLS]", "[SEP]"]
        pieces += ["the", "quick", "brown", "fox", "##es", "inter", "##national", "##ization", "cafe", "東"]
        vocab.write_text("\n".join(pieces) + "\n")
    jt, tt = JaxTokenizer(vocab), TorchTokenizer(vocab)
    for s in STRINGS:
        assert tt.encode(s) == jt.encode(s), s
    jids, jmask = jt.encode_batch(STRINGS)
    tids, tmask = tt.encode_batch(STRINGS)
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_array_equal(tmask, jmask)


def test_embedder_seeded_and_normalised():
    cfg = tm.MiniLMConfig(**SMALL)
    a = tm.MiniLMEmbedder(cfg=cfg, dtype=torch.float32, seed=3)
    b = tm.MiniLMEmbedder(cfg=cfg, dtype=torch.float32, seed=3)
    for (na, pa), (nb, pb) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert na == nb and torch.equal(pa, pb)
    out = a.embed_batch(["alpha beta", "gamma", "delta epsilon zeta"])
    assert out.shape == (3, 64) and out.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-5)
    np.testing.assert_array_equal(a.embed("gamma"), out[1])
    assert a.identity == "minilm-l6-torch-t2/random-init-seed3" and a.dimensions == 64
    assert a.embed_batch([]).shape == (0, 64)
