"""Contrastive training of the bundled embedder, sharded over a (data, tp) mesh.

PyTorch port of `wax_tpu.parallel.train`: a symmetric InfoNCE dual-encoder objective
(query/doc positive pairs, in-batch negatives — the standard sentence-transformers
recipe MiniLM itself was distilled with) and an AdamW train step, on any mesh of
`parallel.mesh`: ("data",), ("data", "tp"), ("slice", "data") or ("slice", "data",
"tp"). Differences from the JAX module:

  * the mesh is single-controller, as the sharded serving programs' are: one process
    issues every device's work from one Python loop, with no host synchronisation in
    a step, and no `torch.distributed`. Where JAX places the batch and the parameters
    and lets GSPMD derive the collectives, the step writes them out:
      - corpus shard s (slice-major over the corpus axes) takes rows [s * B / S,
        (s + 1) * B / S) of the batch on its tp group's lead device (`shard_batch`);
      - each tp device holds its slice of the leaves `param_partition_spec` splits:
        q/k/v and the MLP intermediate by output features (each device adding its
        slice of the replicated bias), attention out and the MLP output by input
        features (the partial products summed on the lead device in tp order, the
        bias added once). Attention runs on whole heads per device where tp divides
        the heads; otherwise q/k/v are gathered whole on the lead device, which gives
        JAX's answer where a head spans devices. Embeddings, LayerNorms and the
        residual stream run once a shard on its lead device;
      - the pooled queries and documents of every shard are copied to the mesh's lead
        device in global batch order, so the in-batch negatives are the global batch,
        as in JAX;
      - each leaf's gradient is assembled (tp slices) and summed (shards, in corpus
        order) on the lead device, where the master leaves and the optimiser state
        live whole; the step then updates them once. Each step takes its devices'
        slices from the master leaves (views where a device is the lead's), so
        logical shards on one card share the master's memory;
      - the same mesh and the same inputs give the same bits: a tensor sent to several
        devices sums its gradients back in the devices' order (`_Fanout`);
  * parameters are `MiniLMEncoder`'s state_dict (torch names, weights [out, in]);
    `init_state` copies them, and each step updates the copies in place, as the JAX
    step donates its state;
  * the optimiser is `optax.adamw(learning_rate, weight_decay=0.01)` written out in
    the order optax applies it: the moments mu and nu (b1 0.9, b2 0.999), the
    bias-corrected ratio mu_hat / (sqrt(nu_hat) + 1e-8) from an int32 count, plus
    0.01 * p on every leaf (optax's mask is None), times -learning_rate, added to p;
  * f32 products (the logits, and the encoder's in f32 compute) run in full f32 on the
    card whatever the process's TF32 setting, as JAX's f32 does;
  * checkpoints keep the JAX module's layout, so a checkpoint written by either
    package on any mesh resumes in the other on any mesh: one npz of `leaf_{i}` in the
    order `jax.tree_util.tree_flatten` visits the JAX TrainState — the flax params
    (dict keys sorted at every level, Dense kernels [in, out]), the Adam count (int32
    ()), mu and nu in the params' order, then the step (int32 ()); optax's
    `add_decayed_weights` and learning-rate states hold no leaves.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from wax_tpu_torch.embed.minilm import (MiniLMEncoder, attend, dense, flax_leaf, layer_norm, mean_pool,
                                        param_partition_spec, tp_split_dim)
from wax_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, data_mesh, shard_rows
from wax_tpu_torch.utils.device import f32_products, full_f32_matmul, resolve_device

__all__ = ["AdamWState", "TrainState", "Trainer", "contrastive_loss"]

B1, B2, EPS, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 0.01


class AdamWState(NamedTuple):
    """optax's ScaleByAdamState: the step count (int32 ()) and the first and second
    moments, dicts keyed like the params."""

    count: torch.Tensor
    mu: dict
    nu: dict


class TrainState(NamedTuple):
    params: dict
    opt_state: AdamWState
    step: torch.Tensor


@full_f32_matmul
def _info_nce(q, d, temperature: float):
    """Symmetric InfoNCE of pooled queries q and documents d [B, hidden], row i of each
    a positive pair, every other row a negative."""
    logits = (q @ d.T) / temperature
    labels = torch.arange(logits.shape[0], device=logits.device)
    l_qd = F.cross_entropy(logits, labels, reduction="none")
    l_dq = F.cross_entropy(logits.T, labels, reduction="none")
    return 0.5 * (l_qd.mean() + l_dq.mean())


def contrastive_loss(params: dict, model: MiniLMEncoder, batch: dict, temperature: float = 0.05):
    """Symmetric InfoNCE over in-batch negatives on one device; `params` is a
    state_dict of `model`."""

    def embed(ids, mask):
        return mean_pool(functional_call(model, params, (ids, mask)), mask)

    return _info_nce(embed(batch["q_ids"], batch["q_mask"]), embed(batch["d_ids"], batch["d_mask"]), temperature)


class _Fanout(torch.autograd.Function):
    """x on each of `devices` (a view where x lies there already). The backward adds
    the devices' gradients onto x's device in the devices' order, so that the sum does
    not depend on which device's backward ends first."""

    @staticmethod
    def forward(ctx, x, devices):
        ctx.device = x.device
        return tuple(x.view_as(x) if d == x.device else x.to(d) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        total = None
        for g in grads:
            if g is not None:
                total = g.to(ctx.device) if total is None else total + g.to(ctx.device)
        return total, None


def _fanout(x, group) -> tuple:
    return (x,) if len(group) == 1 else _Fanout.apply(x, tuple(group))


def _row_parallel(hs, weights, bias, lead):
    """sum_r hs[r] @ weights[r].T, the partial products added on the lead device in tp
    order, plus the bias once."""
    if len(hs) == 1:
        return dense(hs[0], weights[0], bias)
    out = dense(hs[0], weights[0]).to(lead)
    for h, w in zip(hs[1:], weights[1:]):
        out = out + dense(h, w).to(lead)
    return out + bias.to(out.dtype)


def _attention(pieces, group, xs, masks, pre: str, heads: int, scale: float):
    """One layer's self-attention over a shard's tp devices: xs[r] is the layer input
    on device r, pieces[r] its leaves."""
    tp = len(group)

    def proj(r, name):
        return dense(xs[r], pieces[r][f"{pre}{name}.weight"], pieces[r][f"{pre}{name}.bias"])

    if heads % tp == 0:  # whole heads on each device
        ctx = [attend(proj(r, "query"), proj(r, "key"), proj(r, "value"), masks[r], heads // tp, scale)
               for r in range(tp)]
    else:  # a head spans devices: attention runs on q/k/v gathered whole on the lead device
        parts = [torch.cat([proj(r, "query"), proj(r, "key"), proj(r, "value")], -1).to(group[0]) for r in range(tp)]
        q, k, v = (torch.cat(t, -1) for t in zip(*(p.chunk(3, -1) for p in parts)))
        ctx = [c.to(d) for c, d in zip(attend(q, k, v, masks[0], heads, scale).chunk(tp, -1), group)]
    return _row_parallel(ctx, [pieces[r][f"{pre}out.weight"] for r in range(tp)], pieces[0][f"{pre}out.bias"],
                         group[0])


def _encode(model: MiniLMEncoder, pieces, group, ids, mask):
    """`model`'s hidden states [B, L, hidden] for one shard's rows (on the group's lead
    device), computed over its tp devices `group` from pieces[r], device r's leaves: the
    replicated ones (at r = 0 only) and its slices of the split ones."""
    cfg, dt, lead = model.cfg, model.dtype, pieces[0]

    def ln(x, name):
        return layer_norm(x, lead[f"{name}.weight"], lead[f"{name}.bias"], cfg.layer_norm_eps, dt)

    ids = ids.long()
    pos = torch.arange(ids.shape[1], device=ids.device)[None, :]
    emb = F.embedding(ids, lead["tok_emb.weight"]) + F.embedding(pos, lead["pos_emb.weight"])
    emb = emb + F.embedding(torch.zeros_like(ids), lead["type_emb.weight"])
    x = ln(emb.to(dt), "emb_ln")
    masks = [mask.to(d) for d in group]
    scale = model.layer_0.attention.scale
    for i in range(cfg.layers):
        pre = f"layer_{i}."
        attn = _attention(pieces, group, _fanout(x, group), masks, f"{pre}attention.", cfg.heads, scale)
        x = ln(x + attn, f"{pre}attention_ln")
        hs = [F.gelu(dense(xr, pieces[r][f"{pre}intermediate.weight"], pieces[r][f"{pre}intermediate.bias"]),
                     approximate="none") for r, xr in enumerate(_fanout(x, group))]
        out = _row_parallel(hs, [p[f"{pre}output.weight"] for p in pieces], lead[f"{pre}output.bias"], group[0])
        x = ln(x + out, f"{pre}output_ln")
    return x


def _checkpoint_order(names) -> list[str]:
    """The params' names in the order JAX flattens the flax params."""
    return sorted(names, key=lambda n: flax_leaf(n)[0])


class Trainer:
    """Mesh-sharded contrastive trainer for the MiniLM encoder (mesh None: a one-device
    mesh on the current CUDA device, which raises without one)."""

    def __init__(
        self,
        model: MiniLMEncoder,
        mesh: Mesh | None = None,
        learning_rate: float = 2e-5,
        temperature: float = 0.05,
    ):
        self.model = model
        self.mesh = mesh if mesh is not None else data_mesh(resolve_device(None))
        self.device = self.mesh.device
        self.tp = self.mesh.shape.get(MODEL_AXIS, 1)
        self.learning_rate = learning_rate
        self.temperature = temperature
        specs = param_partition_spec(model.state_dict())
        self.split = {n: tp_split_dim(n, spec) for n, spec in specs.items()}
        for n in specs:  # a column-split layer's bias: replicated by the spec, each device adds its slice
            if n.endswith(".bias") and self.split[n[: -len("bias")] + "weight"] == 0:
                self.split[n] = 0

    def init_state(self, params: dict) -> TrainState:
        """Place a copy of the encoder's state_dict on the mesh's lead device and build
        the optimiser state. The copy matters: the step updates the parameters in
        place. A leaf whose split dimension tp does not divide raises ValueError."""
        names = list(self.model.state_dict())
        if set(params) != set(names):
            raise ValueError(f"params do not match the encoder's state_dict: {sorted(set(params) ^ set(names))}")
        placed = {n: torch.as_tensor(params[n]).detach().to(self.device, torch.float32, copy=True) for n in names}
        for n, p in placed.items():
            if self.split[n] is not None and p.shape[self.split[n]] % self.tp:
                raise ValueError(f"{n} {tuple(p.shape)}: tp={self.tp} does not divide dim {self.split[n]}")
        zeros = lambda: {n: torch.zeros_like(p) for n, p in placed.items()}  # noqa: E731
        count = torch.zeros((), dtype=torch.int32, device=self.device)
        step = torch.zeros((), dtype=torch.int32, device=self.device)
        return TrainState(placed, AdamWState(count, zeros(), zeros()), step)

    def shard_batch(self, batch: dict) -> tuple:
        """Each corpus shard's row block of the batch ([B, L] arrays or tensors), a dict
        on the shard's lead device, in corpus order; B that the shards do not divide
        raises ValueError."""
        blocks = {k: shard_rows(self.mesh, v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v)))
                  for k, v in batch.items()}
        return tuple({k: b[s] for k, b in blocks.items()} for s in range(self.mesh.corpus_shards))

    def _pieces(self, params: dict) -> list:
        """This step's autograd leaves: per shard, per tp device, its slices of the
        split leaves and, on the shard's lead device, the replicated leaves (views of
        the master leaves where a device is the lead's, copies elsewhere)."""
        out = []
        for group in self.mesh.shard_groups:
            shard = []
            for r, dev in enumerate(group):
                mine = {}
                for n, p in params.items():
                    dim = self.split[n]
                    if dim is None and r:
                        continue
                    t = p if dim is None else p.narrow(dim, r * (p.shape[dim] // self.tp), p.shape[dim] // self.tp)
                    mine[n] = t.to(dev).detach().requires_grad_()
                shard.append(mine)
            out.append(shard)
        return out

    def loss_and_grads(self, params: dict, batch: dict):
        """(the loss, each leaf's gradient by name on the lead device) of the global
        batch at `params` (master leaves on the lead device, as `init_state` places
        them)."""
        shards = self.shard_batch(batch)
        with f32_products(self.device.type == "cuda"):
            pieces = self._pieces(params)
            q, d = [], []
            for piece, group, blk in zip(pieces, self.mesh.shard_groups, shards):
                for out, side in ((q, "q"), (d, "d")):
                    mask = blk[f"{side}_mask"]
                    hidden = _encode(self.model, piece, group, blk[f"{side}_ids"], mask)
                    out.append(mean_pool(hidden, mask).to(self.device))
            loss = _info_nce(torch.cat(q), torch.cat(d), self.temperature)
            leaves = [t for shard in pieces for mine in shard for t in mine.values()]
            flat = iter(torch.autograd.grad(loss, leaves))
        grads = [[{n: next(flat) for n in mine} for mine in shard] for shard in pieces]
        with torch.no_grad():
            return loss.detach(), {n: self._gather(n, grads) for n in params}

    def _gather(self, name: str, grads: list) -> torch.Tensor:
        """One leaf's gradient on the lead device: each shard's tp slices joined, the
        shards' sums added in corpus order."""
        dim = self.split[name]
        total = None
        for shard in grads:
            if dim is None or self.tp == 1:
                g = shard[0][name].to(self.device)
            else:
                g = torch.cat([mine[name].to(self.device) for mine in shard], dim)
            total = g if total is None else total + g
        return total

    def step(self, state: TrainState, batch: dict):
        """One training step on the global batch: (the updated state, the loss before
        the update). The state's tensors are updated in place and returned in the new
        state."""
        names = list(state.params)
        loss, grads = self.loss_and_grads(state.params, batch)
        with torch.no_grad():
            opt = self._adamw(state, names, [grads[n] for n in names])
        return TrainState(state.params, opt, state.step + 1), loss

    def _adamw(self, state: TrainState, names: list, g: list) -> AdamWState:
        """optax.adamw's update, term by term in optax's order, in place."""
        p = [state.params[n] for n in names]
        mu = [state.opt_state.mu[n] for n in names]
        nu = [state.opt_state.nu[n] for n in names]
        torch._foreach_mul_(mu, B1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - B1))
        g2 = torch._foreach_mul(g, g)
        torch._foreach_mul_(g2, 1 - B2)
        torch._foreach_mul_(nu, B2)
        torch._foreach_add_(nu, g2)
        count = state.opt_state.count + 1
        c = count.float()
        bc1 = 1 - torch.pow(torch.full((), B1, device=c.device), c)
        bc2 = 1 - torch.pow(torch.full((), B2, device=c.device), c)
        u = torch._foreach_div(mu, bc1)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, EPS)
        torch._foreach_div_(u, den)
        torch._foreach_add_(u, torch._foreach_mul(p, WEIGHT_DECAY))
        torch._foreach_mul_(u, -self.learning_rate)
        torch._foreach_add_(p, u)
        return AdamWState(count, state.opt_state.mu, state.opt_state.nu)

    # -------------------------------------------------------------- checkpointing ----
    def save_checkpoint(self, state: TrainState, path) -> None:
        """Durable checkpoint in the JAX module's leaf order (module docstring). The
        write is atomic: a temporary file, fsync, then os.replace."""
        order = _checkpoint_order(state.params)

        def tree(d):
            return [_to_flax_array(n, d[n]) for n in order]

        opt = state.opt_state
        flat = tree(state.params) + [opt.count.cpu().numpy()] + tree(opt.mu) + tree(opt.nu) + [state.step.cpu().numpy()]
        tmp = str(path) + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **{f"leaf_{i}": x for i, x in enumerate(flat)})
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def load_checkpoint(self, template: TrainState, path) -> TrainState:
        """Restore a checkpoint of either package, written on any mesh, onto this
        trainer's mesh (the whole leaves on its lead device); the template (from
        `init_state`) gives the params' names."""
        order = _checkpoint_order(template.params)
        n = len(order)
        with np.load(path) as data:
            if len(data.files) != 3 * n + 2:
                raise ValueError(f"{path}: {len(data.files)} leaves, expected {3 * n + 2} for these params")
            flat = [data[f"leaf_{i}"] for i in range(3 * n + 2)]

        def tree(arrays):
            return {name: _from_flax_array(name, a, self.device) for name, a in zip(order, arrays)}

        def scalar(a):
            return torch.from_numpy(np.asarray(a, np.int32)).to(self.device)

        params, mu, nu = tree(flat[:n]), tree(flat[n + 1 : 2 * n + 1]), tree(flat[2 * n + 1 : 3 * n + 1])
        names = list(template.params)
        reorder = lambda d: {k: d[k] for k in names}  # noqa: E731
        return TrainState(reorder(params), AdamWState(scalar(flat[n]), reorder(mu), reorder(nu)), scalar(flat[-1]))


def _to_flax_array(name: str, t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return np.ascontiguousarray(a.T) if flax_leaf(name)[1] else a


def _from_flax_array(name: str, a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a, np.float32)
    return torch.from_numpy(np.ascontiguousarray(a.T) if flax_leaf(name)[1] else a.copy()).to(device)
