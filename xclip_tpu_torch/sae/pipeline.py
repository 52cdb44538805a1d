"""SAE training over cached activation shards.

Counterpart of ``xclip_tpu/sae/pipeline.py``. Per epoch: load a shard,
train on shuffled batches, step the dead-neuron resampler, validate, save
checkpoints. A shard is copied to the device once (fp16 on disk, fp32 on
the device); each train step is, in the JAX package's order: forward, loss
(batch mean of l1 penalty + l2 reconstruction), gradients by autograd,
``remove_parallel_gradient`` on the decoder gradient, Adam,
``constrain_decoder_unit_norm``. The products are fp32 ``torch.matmul``s
(the JAX package leaves them to XLA too); the caller decides TF32, which
the port's fp32 paths keep off.

Firing counts are summed on the device and read once per shard, and the
train loss is read only when it is logged, so steps queue without waiting
for the host. Randomness is one ``np.random.RandomState(seed)``, drawn in
the JAX package's order (shard order, then each shard's batch order).
Checkpoints are ``.pt`` state dicts with the reference's key names.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from xclip_tpu_torch.sae.losses import SAELossCfg, itemwise_losses, sae_loss
from xclip_tpu_torch.sae.model import (
    Params,
    constrain_decoder_unit_norm,
    remove_parallel_gradient,
    sae_apply,
    sae_params_to_state_dict,
    tree_leaves,
    tree_map,
)
from xclip_tpu_torch.sae.optim import Adam, reset_neuron_moments
from xclip_tpu_torch.sae.resampler import ActivationResampler, apply_parameter_updates

VAL_KEYS = ("learned_activations_l1_loss", "learned_activations_l1_loss_penalty",
            "l2_reconstruction_loss", "total_loss")


def load_activation_shard(path: str) -> np.ndarray:
    """Load one cached activation shard (.npy, .npz or torch .pt/.pth)."""
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith(".npz"):
        with np.load(path) as z:
            return z[z.files[0]]
    t = torch.load(path, map_location="cpu", weights_only=True)
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def train_step(params: Params, optimizer: Adam, opt_state, loss_cfg: SAELossCfg, batch: torch.Tensor):
    """One SAE step -> (new params, batch-mean loss terms, per-neuron firing
    counts ([components,] m)). ``opt_state`` is advanced in place."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    with torch.enable_grad():
        learned, decoded = sae_apply(leaves, batch)
        loss, metrics = sae_loss(loss_cfg, batch, learned, decoded)
        grad_list = torch.autograd.grad(loss, tree_leaves(leaves))
    it = iter(grad_list)
    grads = tree_map(lambda _: next(it), leaves)
    with torch.no_grad():
        grads = remove_parallel_gradient(leaves, grads)
        new_params = optimizer.update(grads, opt_state, tree_map(torch.Tensor.detach, leaves))
        new_params = constrain_decoder_unit_norm(new_params)
        fired = torch.sum(learned.detach() > 0, dim=0)
    return new_params, {k: v.detach() for k, v in metrics.items()}, fired


class Pipeline:
    """Drives SAE training; mirrors the JAX ``Pipeline``. ``params`` live on
    their device, which is where shards are copied and steps run."""

    def __init__(
        self,
        autoencoder_params: Params,
        loss_cfg: SAELossCfg,
        optimizer: Adam,
        checkpoint_directory: str,
        activation_resampler: Optional[ActivationResampler] = None,
        log_frequency: int = 100,
        logger=None,
        seed: int = 0,
    ):
        self.params = autoencoder_params
        self.loss_cfg = loss_cfg
        self.optimizer = optimizer
        self.opt_state = optimizer.init(autoencoder_params)
        self.activation_resampler = activation_resampler
        self.checkpoint_directory = checkpoint_directory
        self.log_frequency = log_frequency
        self.logger = logger
        self.total_activations_trained_on = 0
        self._rng = np.random.RandomState(seed)
        self._has_components = autoencoder_params["encoder"]["weight"].dim() == 3
        self.device = autoencoder_params["tied_bias"].device

    # ------------------------------------------------------------------
    def get_activation_store(self, activation_fname: str) -> np.ndarray:
        acts = np.asarray(load_activation_shard(activation_fname))
        if self._has_components and acts.ndim == 2:
            acts = acts[:, None, :]
        return acts

    def train_autoencoder(self, store: np.ndarray, train_batch_size: int) -> np.ndarray:
        """One pass over a shard (the remainder of a batch dropped); returns
        per-neuron firing counts (m,) of component 0."""
        n = len(store)
        order = torch.from_numpy(self._rng.permutation(n)).to(self.device)
        device_store = torch.from_numpy(store).to(self.device, torch.float32)
        m = self.params["encoder"]["bias"].shape[-1]
        fired_total = torch.zeros(m, dtype=torch.int64, device=self.device)
        for i in range(0, n - train_batch_size + 1, train_batch_size):
            batch = device_store[order[i : i + train_batch_size]]
            self.params, metrics, fired = train_step(self.params, self.optimizer, self.opt_state,
                                                     self.loss_cfg, batch)
            fired_total += fired[0] if fired.dim() > 1 else fired
            self.total_activations_trained_on += train_batch_size
            step_no = self.total_activations_trained_on // train_batch_size
            if self.logger is not None and step_no % self.log_frequency == 0:
                self.logger.add_scalar("Loss/train", float(metrics["total_loss"]),
                                       self.total_activations_trained_on)
        return fired_total.cpu().numpy()

    @torch.no_grad()
    def validation(self, store: np.ndarray, train_batch_size: int) -> Dict[str, float]:
        """Mean over batches of each batch-mean loss term."""
        sums = {k: 0.0 for k in VAL_KEYS}
        count = 0
        for i in range(0, len(store), train_batch_size):
            batch = torch.from_numpy(store[i : i + train_batch_size]).to(self.device, torch.float32)
            learned, decoded = sae_apply(self.params, batch)
            items = itemwise_losses(self.loss_cfg, batch, learned, decoded)
            for k in VAL_KEYS:
                sums[k] += float(torch.mean(items[k]))
            count += 1
        means = {k: v / max(count, 1) for k, v in sums.items()}
        if self.logger is not None:
            for i, k in enumerate(VAL_KEYS):
                self.logger.add_scalar(f"Loss/val_{i}", means[k], self.total_activations_trained_on)
            self.logger.add_scalar("Loss/val_total", means["total_loss"], self.total_activations_trained_on)
        return means

    def update_parameters(self, updates) -> None:
        self.params = apply_parameter_updates(self.params, updates)
        reset_neuron_moments(self.opt_state, updates.dead_neuron_indices, has_components=self._has_components)

    def save_checkpoint(self, *, is_final: bool = False) -> str:
        os.makedirs(self.checkpoint_directory, exist_ok=True)
        name = f"sparse_autoencoder_{'final' if is_final else self.total_activations_trained_on}"
        path = os.path.join(self.checkpoint_directory, f"{name}.pt")
        torch.save(sae_params_to_state_dict(self.params), path)
        return path

    def run_pipeline(
        self,
        train_batch_size: int,
        val_frequency: int = 0,
        checkpoint_frequency: int = 0,
        num_epochs: int = 1,
        train_fnames: Optional[List[str]] = None,
        train_val_fnames: Optional[List[str]] = None,
    ) -> None:
        """Epoch loop over shard files: each of ``num_epochs`` passes visits
        every file once, in an order redrawn per pass."""
        if not train_fnames:
            raise ValueError("run_pipeline needs at least one training shard")
        piece_order = self._rng.permutation(len(train_fnames))
        piece_idx = 0
        actual_epochs = num_epochs * len(train_fnames)
        last_validated = last_checkpoint = 0

        for epoch in range(actual_epochs):
            fname = train_fnames[piece_order[piece_idx]]
            piece_idx += 1
            if piece_idx == len(train_fnames):
                piece_idx = 0
                piece_order = self._rng.permutation(len(train_fnames))

            store = self.get_activation_store(fname)
            fired = self.train_autoencoder(store, train_batch_size)

            if self.activation_resampler is not None:
                updates = self.activation_resampler.step_resampler(
                    fired, store, self.params, self.loss_cfg, train_batch_size
                )
                if updates is not None:
                    logging.info("Resampling %d dead neurons", len(updates.dead_neuron_indices))
                    self.update_parameters(updates)

            last_validated += len(store)
            last_checkpoint += len(store)
            if val_frequency and last_validated >= val_frequency and train_val_fnames:
                last_validated = 0
                val_store = self.get_activation_store(train_val_fnames[0])
                means = self.validation(val_store, train_batch_size)
                logging.info("epoch %d validation: %s", epoch, means)
            if checkpoint_frequency and last_checkpoint >= checkpoint_frequency:
                last_checkpoint = 0
                self.save_checkpoint()

        self.save_checkpoint(is_final=True)
