"""Contrastive training of the bundled embedder on one device.

PyTorch port of `wax_tpu.parallel.train`: a symmetric InfoNCE dual-encoder objective
(query/doc positive pairs, in-batch negatives — the standard sentence-transformers
recipe MiniLM itself was distilled with) and an AdamW train step. Differences from
the JAX module:

  * the mesh is a one-device `data_mesh`; a mesh of more than one shard
    raises (multi-GPU training is ROADMAP queue 1, item 5), so the batch and every
    parameter live whole on the mesh's device;
  * parameters are `MiniLMEncoder`'s state_dict (torch names, weights [out, in]);
    `init_state` copies them, and each step runs `torch.func.functional_call` on the
    copies and then updates them in place, as the JAX step donates its state;
  * the optimiser is `optax.adamw(learning_rate, weight_decay=0.01)` written out in
    the order optax applies it: the moments mu and nu (b1 0.9, b2 0.999), the
    bias-corrected ratio mu_hat / (sqrt(nu_hat) + 1e-8) from an int32 count, plus
    0.01 * p on every leaf (optax's mask is None), times -learning_rate, added to p;
  * checkpoints keep the JAX module's layout, so a checkpoint written by either
    package resumes in the other: one npz of `leaf_{i}` in the order
    `jax.tree_util.tree_flatten` visits the JAX TrainState — the flax params (dict
    keys sorted at every level, Dense kernels [in, out]), the Adam count (int32 ()),
    mu and nu in the params' order, then the step (int32 ()); optax's
    `add_decayed_weights` and learning-rate states hold no leaves.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from wax_tpu_torch.embed.minilm import MiniLMEncoder, flax_leaf, mean_pool
from wax_tpu_torch.parallel.mesh import Mesh, corpus_shards, data_mesh
from wax_tpu_torch.utils.device import resolve_device

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


def contrastive_loss(params: dict, model: MiniLMEncoder, batch: dict, temperature: float = 0.05):
    """Symmetric InfoNCE over in-batch negatives; `params` is a state_dict of `model`."""

    def embed(ids, mask):
        return mean_pool(functional_call(model, params, (ids, mask)), mask)

    q = embed(batch["q_ids"], batch["q_mask"])
    d = embed(batch["d_ids"], batch["d_mask"])
    logits = (q @ d.T) / temperature
    labels = torch.arange(logits.shape[0], device=logits.device)
    l_qd = F.cross_entropy(logits, labels, reduction="none")
    l_dq = F.cross_entropy(logits.T, labels, reduction="none")
    return 0.5 * (l_qd.mean() + l_dq.mean())


def _checkpoint_order(names) -> list[str]:
    """The params' names in the order JAX flattens the flax params."""
    return sorted(names, key=lambda n: flax_leaf(n)[0])


class Trainer:
    """Contrastive trainer for the MiniLM encoder on a one-device mesh (None: the
    current CUDA device, which raises without one)."""

    def __init__(
        self,
        model: MiniLMEncoder,
        mesh: Mesh | None = None,
        learning_rate: float = 2e-5,
        temperature: float = 0.05,
    ):
        mesh = mesh if mesh is not None else data_mesh(resolve_device(None))
        if corpus_shards(mesh) != 1:
            raise NotImplementedError(
                "training over more than one device is not ported yet (ROADMAP queue 1, item 5: multi-GPU)"
            )
        self.model = model
        self.mesh = mesh
        self.device = mesh.device
        self.learning_rate = learning_rate
        self.temperature = temperature

    def init_state(self, params: dict) -> TrainState:
        """Place a copy of the encoder's state_dict on the device and build the
        optimiser state. The copy matters: the step updates the parameters in place."""
        names = list(self.model.state_dict())
        if set(params) != set(names):
            raise ValueError(f"params do not match the encoder's state_dict: {sorted(set(params) ^ set(names))}")
        placed = {n: torch.as_tensor(params[n]).detach().to(self.device, torch.float32, copy=True) for n in names}
        zeros = lambda: {n: torch.zeros_like(p) for n, p in placed.items()}  # noqa: E731
        count = torch.zeros((), dtype=torch.int32, device=self.device)
        step = torch.zeros((), dtype=torch.int32, device=self.device)
        return TrainState(placed, AdamWState(count, zeros(), zeros()), step)

    def shard_batch(self, batch: dict) -> dict:
        """Batch leaves ([B, L] arrays or tensors) on the mesh's device."""
        return {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))).to(self.device)
                for k, v in batch.items()}

    def step(self, state: TrainState, batch: dict):
        """One training step: (the updated state, the loss before the update). The
        state's tensors are updated in place and returned in the new state."""
        batch = self.shard_batch(batch)
        names = list(state.params)
        leaves = [state.params[n].detach().requires_grad_() for n in names]
        loss = contrastive_loss(dict(zip(names, leaves)), self.model, batch, self.temperature)
        grads = list(torch.autograd.grad(loss, leaves))
        with torch.no_grad():
            opt = self._adamw(state, names, grads)
        return TrainState(state.params, opt, state.step + 1), loss.detach()

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
        bc1 = 1 - torch.pow(torch.tensor(B1, device=c.device), c)
        bc2 = 1 - torch.pow(torch.tensor(B2, device=c.device), c)
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
        """Restore a checkpoint of either package onto this trainer's device; the
        template (from `init_state`) gives the params' names."""
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
