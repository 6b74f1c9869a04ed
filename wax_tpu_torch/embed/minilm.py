"""MiniLM-architecture sentence encoder as a torch `nn.Module`.

PyTorch port of `wax_tpu.embed.minilm`: a 6-layer, 384-wide BERT encoder, mean pooling
and L2 normalisation, fed by the WordPiece tokenizer. Submodules carry the flax tree's
names (`tok_emb`, `layer_0.attention.query`, ...), so `params_from_flax` and its inverse
`params_to_flax` are tables.

Numerics follow the JAX package, so both compute the same thing on the same weights:
parameters are stored in f32 and dense layers run in the compute dtype (bf16 by
default); the embedding sum is taken in f32 before the embedding LayerNorm; LayerNorm
statistics are f32 with eps 1e-12; attention is plain tensor ops (einsum, scale and
the -1e9 mask bias in the compute dtype, softmax), not a fused attention operator;
GELU is exact; mean pooling divides in the hidden dtype before casting to f32. In f32
compute the products stay f32 on the card whatever the process's TF32 setting. The
layers are built from `dense`, `layer_norm` and `attend`, which the trainer also calls
on each device's slices of the weights; `param_partition_spec` gives those slices,
JAX's tensor-parallel layout.

Without a checkpoint the weights are random, drawn from a seeded torch.Generator:
dense kernels N(0, 1/fan_in), token embeddings N(0, 1), position and type embeddings
N(0, 0.02^2), LayerNorm scale 1, biases 0. The small position and type embeddings keep
the pooled vectors of different texts apart, so random-weight retrieval has few ties.
"""
from __future__ import annotations

import math
from pathlib import Path
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from wax_tpu_torch.embed.provider import ExecutionMode
from wax_tpu_torch.text.wordpiece import WordPieceTokenizer
from wax_tpu_torch.utils.device import f32_products, resolve_device

__all__ = [
    "MiniLMConfig",
    "MiniLMEncoder",
    "MiniLMEmbedder",
    "mean_pool",
    "params_from_flax",
    "params_to_flax",
    "flax_leaf",
    "param_partition_spec",
    "tp_split_dim",
    "dense",
    "layer_norm",
    "attend",
    "load_hf_checkpoint",
]


class MiniLMConfig:
    vocab_size: int = 30522
    hidden: int = 384
    layers: int = 6
    heads: int = 12
    intermediate: int = 1536
    max_positions: int = 512
    type_vocab: int = 2
    layer_norm_eps: float = 1e-12

    def __init__(self, **kw):
        for k, v in kw.items():
            if not hasattr(type(self), k):
                raise TypeError(f"unknown config field {k}")
            setattr(self, k, v)


def dense(x, weight, bias=None):
    """flax `nn.Dense(dtype=..., param_dtype=f32)` on a weight [out, in]: the f32
    parameters cast to the input's dtype, the product computed in it."""
    return F.linear(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype))


def layer_norm(x, weight, bias, eps: float, dtype: torch.dtype):
    """flax `nn.LayerNorm`: f32 statistics (E[x^2] - E[x]^2, clipped at 0), output in
    `dtype`."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp(min=0.0)
    y = (xf - mean) * (torch.rsqrt(var + eps) * weight)
    return (y + bias).to(dtype)


def attend(q, k, v, mask, heads: int, scale: float):
    """Self-attention of q, k, v [B, L, heads * head_dim] over `heads` heads of
    consecutive features: scores divided by `scale`, the -1e9 bias of padded keys,
    softmax; the context [B, L, heads * head_dim]."""
    b, n, width = q.shape

    def split(t):
        return t.reshape(b, n, heads, width // heads)

    scores = torch.einsum("bqhd,bkhd->bhqk", split(q), split(k)) / scale
    bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e9).to(scores.dtype)
    probs = torch.softmax(scores + bias, dim=-1)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs, split(v))
    return ctx.reshape(b, n, width)


class _Dense(nn.Module):
    """`dense` over its own parameters; `weight` is [out, in] as in `nn.Linear`."""

    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(n_out, n_in))
        self.bias = nn.Parameter(torch.zeros(n_out))

    def forward(self, x):
        return dense(x, self.weight, self.bias)


class _LayerNorm(nn.Module):
    """`layer_norm` over its own parameters."""

    def __init__(self, n: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.eps = eps
        self.dtype = dtype

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps, self.dtype)


class _SelfAttention(nn.Module):
    def __init__(self, cfg: MiniLMConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        h = cfg.hidden
        self.query, self.key, self.value, self.out = (_Dense(h, h) for _ in range(4))
        # sqrt(head_dim) rounded to the compute dtype, as the JAX package divides by it
        root = torch.tensor(math.sqrt(cfg.hidden // cfg.heads), dtype=torch.float32)
        self.scale = float(root.to(dtype))

    def forward(self, x, mask):
        return self.out(attend(self.query(x), self.key(x), self.value(x), mask, self.cfg.heads, self.scale))


class _Layer(nn.Module):
    def __init__(self, cfg: MiniLMConfig, dtype: torch.dtype):
        super().__init__()
        eps = cfg.layer_norm_eps
        self.attention = _SelfAttention(cfg, dtype)
        self.attention_ln = _LayerNorm(cfg.hidden, eps, dtype)
        self.intermediate = _Dense(cfg.hidden, cfg.intermediate)
        self.output = _Dense(cfg.intermediate, cfg.hidden)
        self.output_ln = _LayerNorm(cfg.hidden, eps, dtype)

    def forward(self, x, mask):
        x = self.attention_ln(x + self.attention(x, mask))
        h = F.gelu(self.intermediate(x), approximate="none")
        return self.output_ln(x + self.output(h))


class MiniLMEncoder(nn.Module):
    """BERT encoder returning token-level hidden states [B, L, hidden] in `dtype`."""

    def __init__(self, cfg: MiniLMConfig, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.tok_emb = nn.Embedding(cfg.vocab_size, cfg.hidden)
        self.pos_emb = nn.Embedding(cfg.max_positions, cfg.hidden)
        self.type_emb = nn.Embedding(cfg.type_vocab, cfg.hidden)
        self.emb_ln = _LayerNorm(cfg.hidden, cfg.layer_norm_eps, dtype)
        for i in range(cfg.layers):
            self.add_module(f"layer_{i}", _Layer(cfg, dtype))

    def forward(self, ids, mask):
        # f32 compute stays f32 on the card whatever the process's TF32 setting
        with f32_products(self.dtype == torch.float32 and ids.is_cuda):
            ids = ids.long()
            pos = torch.arange(ids.shape[1], device=ids.device)[None, :]
            emb = self.tok_emb(ids) + self.pos_emb(pos)
            emb = emb + self.type_emb(torch.zeros_like(ids))
            x = self.emb_ln(emb.to(self.dtype))
            for i in range(self.cfg.layers):
                x = getattr(self, f"layer_{i}")(x, mask)
            return x

    @torch.no_grad()
    def init_random(self, generator: torch.Generator) -> None:
        """Seeded random weights (see the module docstring for the scheme)."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name == "tok_emb.weight":
                p.copy_(torch.randn(p.shape, generator=generator))
            elif name in ("pos_emb.weight", "type_emb.weight"):
                p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
            elif leaf == "weight" and p.dim() == 2:
                p.copy_(torch.randn(p.shape, generator=generator) / math.sqrt(p.shape[1]))
            elif leaf == "weight":
                p.fill_(1.0)
            else:
                p.zero_()


def mean_pool(hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mask-weighted mean pooling + L2 normalisation -> [B, hidden] f32."""
    m = mask[..., None].to(hidden.dtype)
    summed = (hidden * m).sum(dim=1)
    counts = m.sum(dim=1).clamp(min=1.0)
    pooled = (summed / counts).float()
    norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
    return pooled / norm.clamp(min=1e-12)


# flax leaf name -> (torch leaf name, transpose)
_FLAX_LEAF = {"kernel": ("weight", True), "scale": ("weight", False), "embedding": ("weight", False), "bias": ("bias", False)}


def params_from_flax(tree) -> dict[str, torch.Tensor]:
    """Map the JAX package's flax params (a nested dict of numpy arrays) onto
    `MiniLMEncoder`'s state_dict: Dense kernels [in, out] become weights [out, in];
    LayerNorm scale/bias become weight/bias; nn.Embed tables become nn.Embedding."""
    out: dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for key, val in node.items():
            if isinstance(val, dict) or hasattr(val, "items"):
                walk(val, prefix + [key])
                continue
            leaf, transpose = _FLAX_LEAF[key]
            arr = np.asarray(val, np.float32)
            out[".".join(prefix + [leaf])] = torch.tensor(arr.T if transpose else arr)

    walk(tree, [])
    return out


def flax_leaf(name: str) -> tuple[tuple[str, ...], bool]:
    """(path in the flax params, transposed) of a `MiniLMEncoder` state_dict entry:
    Dense weights [out, in] are kernels [in, out], LayerNorm weights are `scale`, the
    embedding tables are `embedding`."""
    *path, leaf = name.split(".")
    if leaf == "bias":
        return (*path, "bias"), False
    if path[-1].endswith("_emb"):
        return (*path, "embedding"), False
    if path[-1].endswith("_ln"):
        return (*path, "scale"), False
    return (*path, "kernel"), True


def param_partition_spec(state_dict) -> dict[str, tuple]:
    """The tensor-parallel layout of each state_dict entry over a "tp" mesh axis, as the
    axes of the JAX package's PartitionSpec for its flax leaf (`flax_leaf`), by JAX's
    rule on the leaf's path: 2-D leaves under query, key, value or intermediate split
    their output features, (None, "tp"); leaves ending out/kernel or holding
    output/kernel split their input features, ("tp", None); every other leaf is
    replicated, () — the 1-D q/k/v and intermediate biases too."""
    out = {}
    for name, val in state_dict.items():
        joined = "/".join(flax_leaf(name)[0])
        spec = ()
        if np.ndim(val) == 2:
            if any(s in joined for s in ("query", "key", "value", "intermediate")):
                spec = (None, "tp")
            elif joined.endswith("out/kernel") or "output/kernel" in joined:
                spec = ("tp", None)
        out[name] = spec
    return out


def tp_split_dim(name: str, spec: tuple) -> int | None:
    """The dimension of the state_dict entry `name` that `spec` (from
    `param_partition_spec`) splits over "tp", None for a replicated leaf. Dense weights
    are [out, in], flax's kernels [in, out], so (None, "tp") splits a weight's dim 0."""
    if "tp" not in spec:
        return None
    dim = spec.index("tp")
    return len(spec) - 1 - dim if flax_leaf(name)[1] else dim


def params_to_flax(state_dict) -> dict:
    """The inverse of `params_from_flax`: `MiniLMEncoder`'s state_dict (tensors or
    arrays) as the JAX package's flax params, a nested dict of f32 numpy arrays. Both
    directions copy values exactly, so a round trip is the identity."""
    out: dict = {}
    for name, val in state_dict.items():
        path, transpose = flax_leaf(name)
        arr = np.array(val.detach().cpu() if isinstance(val, torch.Tensor) else val, np.float32)
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.ascontiguousarray(arr.T) if transpose else arr
    return out


def _hf_names(cfg: MiniLMConfig) -> dict[str, str]:
    """HuggingFace BertModel state_dict name -> MiniLMEncoder name."""
    names = {
        "embeddings.word_embeddings.weight": "tok_emb.weight",
        "embeddings.position_embeddings.weight": "pos_emb.weight",
        "embeddings.token_type_embeddings.weight": "type_emb.weight",
        "embeddings.LayerNorm.weight": "emb_ln.weight",
        "embeddings.LayerNorm.bias": "emb_ln.bias",
    }
    per_layer = {
        "attention.self.query": "attention.query",
        "attention.self.key": "attention.key",
        "attention.self.value": "attention.value",
        "attention.output.dense": "attention.out",
        "attention.output.LayerNorm": "attention_ln",
        "intermediate.dense": "intermediate",
        "output.dense": "output",
        "output.LayerNorm": "output_ln",
    }
    for i in range(cfg.layers):
        for hf, ours in per_layer.items():
            for leaf in ("weight", "bias"):
                names[f"encoder.layer.{i}.{hf}.{leaf}"] = f"layer_{i}.{ours}.{leaf}"
    return names


def load_hf_checkpoint(path: str | Path, cfg: MiniLMConfig) -> dict[str, torch.Tensor]:
    """Read a HuggingFace sentence-transformers MiniLM checkpoint directory
    (`pytorch_model.bin`, or `model.safetensors`) into a `MiniLMEncoder` state_dict."""
    path = Path(path)
    st, pt = path / "model.safetensors", path / "pytorch_model.bin"
    if st.exists():
        from safetensors.torch import load_file

        raw = load_file(str(st))
    elif pt.exists():
        raw = torch.load(str(pt), map_location="cpu", weights_only=True)
    else:
        raise FileNotFoundError(f"no checkpoint found under {path}")
    raw = {k.removeprefix("bert."): v for k, v in raw.items()}
    return {ours: raw[hf].float() for hf, ours in _hf_names(cfg).items()}


class MiniLMEmbedder:
    """EmbeddingProvider over `MiniLMEncoder` (batch-first, weights on `device`)."""

    def __init__(
        self,
        checkpoint_dir: str | Path | None = None,
        vocab_path: str | Path | None = None,
        dtype: torch.dtype = torch.bfloat16,
        batch_size: int = 256,
        seed: int = 0,
        device: str | torch.device | None = None,
        cfg: MiniLMConfig | None = None,
    ):
        self.cfg = cfg if cfg is not None else MiniLMConfig()
        self.device = resolve_device(device)
        self.model = MiniLMEncoder(self.cfg, dtype=dtype)
        if vocab_path is None and checkpoint_dir and (Path(checkpoint_dir) / "vocab.txt").exists():
            vocab_path = Path(checkpoint_dir) / "vocab.txt"
        self.tokenizer = WordPieceTokenizer(vocab_path, vocab_size=self.cfg.vocab_size)
        self._batch_size = batch_size
        if checkpoint_dir is not None:
            self.model.load_state_dict(load_hf_checkpoint(checkpoint_dir, self.cfg))
            self._weights_tag = _weights_fingerprint(Path(checkpoint_dir))
        else:
            self.model.init_random(torch.Generator().manual_seed(seed))
            self._weights_tag = f"random-init-seed{seed}"
        self.model.to(self.device).eval()

    @property
    def dimensions(self) -> int:
        return self.cfg.hidden

    @property
    def identity(self) -> str:
        return f"minilm-l6-torch-t2/{self._weights_tag}"

    @property
    def normalized(self) -> bool:
        return True

    @property
    def execution_mode(self) -> str:
        return ExecutionMode.ON_DEVICE_ONLY

    @property
    def batch_size(self) -> int:
        return self._batch_size

    @torch.no_grad()
    def encode(self, texts: Sequence[str]) -> torch.Tensor:
        """Unit-norm embeddings [len(texts), hidden] f32 on the embedder's device."""
        if not texts:
            return torch.zeros((0, self.cfg.hidden), device=self.device)
        out = []
        for i in range(0, len(texts), self._batch_size):
            ids, mask = self.tokenizer.encode_batch(list(texts[i : i + self._batch_size]))
            ids = torch.from_numpy(ids).to(self.device)
            mask = torch.from_numpy(mask).to(self.device)
            out.append(mean_pool(self.model(ids, mask), mask))
        return torch.cat(out)

    def embed(self, text: str) -> np.ndarray:
        return self.embed_batch([text])[0]

    def embed_batch(self, texts: Sequence[str]) -> np.ndarray:
        return self.encode(texts).cpu().numpy()


def _weights_fingerprint(path: Path) -> str:
    """sha256 over (name, size, first 1 MiB) of each weight file."""
    import hashlib

    h = hashlib.sha256()
    for name in ("model.safetensors", "pytorch_model.bin"):
        f = path / name
        if f.exists():
            h.update(name.encode())
            h.update(str(f.stat().st_size).encode())
            with open(f, "rb") as fh:
                h.update(fh.read(1 << 20))
    return h.hexdigest()[:16]
