"""Dead-neuron activation resampler.

Counterpart of ``xclip_tpu/sae/resampler.py``: collate neuron firing counts
over an activity window; at the resample point (and when the
``resample_epoch_freq`` gate passes) pick inputs with probability
proportional to the squared SAE loss, set the dead decoder columns to the
normalized inputs, the dead encoder rows to the same directions scaled to
0.2x the mean alive encoder-row norm, zero the dead encoder biases, and
reset the Adam moments of those neurons.

The bookkeeping is host numpy, the same operations on the same arrays as
the JAX package, with one ``np.random.RandomState(seed)`` drawn in the same
order; only the loss over the resample dataset runs on the device. With a
components axis (the SAE CLI's default layout) the resampler works on
component 0, whose inputs it takes as (n, d): the JAX package keeps them as
(n, 1, d) and its parameter update then fails to broadcast whenever a
neuron is dead.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from xclip_tpu_torch.sae.losses import SAELossCfg, loss_per_item
from xclip_tpu_torch.sae.model import Params, sae_apply


@dataclasses.dataclass
class ParameterUpdateResults:
    dead_neuron_indices: np.ndarray
    dead_encoder_weight_updates: np.ndarray  # (n_dead, d)
    dead_encoder_bias_updates: np.ndarray  # (n_dead,)
    dead_decoder_weight_updates: np.ndarray  # (d, n_dead)


class ActivationResampler:
    """Stateful host-side resampler of one component."""

    def __init__(
        self,
        n_learned_features: int,
        resample_interval: int = 200_000_000,
        max_n_resamples: int = 4,
        n_activations_activity_collate: int = 100_000_000,
        resample_dataset_size: int = 819_200,
        threshold_is_dead_portion_fires: float = 0.0,
        resample_epoch_freq: Optional[int] = None,
        seed: int = 0,
    ):
        if n_activations_activity_collate > resample_interval:
            raise ValueError("collate window must be <= resample interval")
        self.neuron_activity_window_end = resample_interval
        self.neuron_activity_window_start = resample_interval - n_activations_activity_collate
        self._max_n_resamples = max_n_resamples
        self._resample_dataset_size = resample_dataset_size
        self._threshold_is_dead_portion_fires = threshold_is_dead_portion_fires
        self.resample_epoch_freq = resample_epoch_freq or 0
        self.epoch_since_last_resample = 0

        self._collated_neuron_activity = np.zeros(n_learned_features, np.int64)
        self._activations_seen_since_last_resample = 0
        self._n_activations_collated_since_last_resample = 0
        self._n_times_resampled = 0
        self._rng = np.random.RandomState(seed)

    # -- pieces -------------------------------------------------------------
    def _get_dead_neuron_indices(self) -> np.ndarray:
        if not np.any(self._collated_neuron_activity):
            raise ValueError("Cannot get dead neuron indices without neuron activity.")
        threshold = int(
            self._n_activations_collated_since_last_resample * self._threshold_is_dead_portion_fires
        )
        return np.where(self._collated_neuron_activity <= threshold)[0].astype(np.int64)

    @staticmethod
    def assign_sampling_probabilities(loss: np.ndarray) -> np.ndarray:
        sq = np.square(loss.astype(np.float64))
        return sq / sq.sum(0)

    def sample_input(self, probabilities: np.ndarray, inputs: np.ndarray, n_samples: int) -> np.ndarray:
        if n_samples == 0:
            return np.empty((0, inputs.shape[-1]), inputs.dtype)
        if n_samples > len(inputs):
            raise ValueError(f"Cannot sample {n_samples} inputs from {len(inputs)}.")
        idx = self._rng.choice(len(inputs), size=n_samples, replace=False, p=probabilities)
        return inputs[idx]

    @staticmethod
    def renormalize_and_scale(sampled: np.ndarray, neuron_activity: np.ndarray,
                              encoder_weight: np.ndarray) -> np.ndarray:
        alive = neuron_activity > 0
        if not np.any(alive):
            raise ValueError("No alive neurons found.")
        if len(sampled) == 0:
            return np.empty((0, sampled.shape[-1]), sampled.dtype)
        alive_norm = np.linalg.norm(encoder_weight[alive], axis=-1).mean()
        unit = sampled / np.maximum(np.linalg.norm(sampled, axis=-1, keepdims=True), 1e-12)
        return unit * (alive_norm * 0.2)

    # -- main ---------------------------------------------------------------
    @torch.no_grad()
    def compute_loss_and_get_activations(self, store: np.ndarray, params: Params,
                                         loss_cfg: SAELossCfg, batch_size: int):
        """Loss per item of ``resample_dataset_size`` random rows of the store
        -> (loss (n,), inputs (n, d) of component 0)."""
        n = self._resample_dataset_size
        order = self._rng.permutation(len(store))[: max(n, batch_size)]
        if len(order) < n:
            raise ValueError(f"Cannot get {n} items from the store ({len(order)} available).")
        inputs = np.asarray(store)[order[:n]]
        device = params["tied_bias"].device
        losses = []
        for i in range(0, n, batch_size):
            x = torch.from_numpy(inputs[i : i + batch_size]).to(device, torch.float32)
            learned, decoded = sae_apply(params, x)
            losses.append(loss_per_item(loss_cfg, x, learned, decoded).cpu().numpy())
        loss = np.concatenate(losses)
        if loss.ndim > 1:  # components axis -> component 0
            loss, inputs = loss[:, 0], inputs[:, 0]
        return loss, inputs

    def resample_dead_neurons(self, store, params: Params, loss_cfg: SAELossCfg,
                              batch_size: int) -> ParameterUpdateResults:
        dead = self._get_dead_neuron_indices()
        loss, inputs = self.compute_loss_and_get_activations(store, params, loss_cfg, batch_size)
        probs = self.assign_sampling_probabilities(loss)
        sampled = self.sample_input(probs, inputs, len(dead))

        unit = sampled / np.maximum(np.linalg.norm(sampled, axis=-1, keepdims=True), 1e-12)
        enc_w = params["encoder"]["weight"].detach().cpu().numpy()
        if enc_w.ndim == 3:
            enc_w = enc_w[0]
        rescaled = self.renormalize_and_scale(sampled, self._collated_neuron_activity, enc_w)

        return ParameterUpdateResults(
            dead_neuron_indices=dead,
            dead_encoder_weight_updates=rescaled,
            dead_encoder_bias_updates=np.zeros(len(dead), np.float32),
            dead_decoder_weight_updates=unit.T,
        )

    def step_resampler(self, batch_neuron_activity: np.ndarray, store, params: Params,
                       loss_cfg: SAELossCfg, batch_size: int) -> Optional[ParameterUpdateResults]:
        """Called once per epoch (shard pass); returns the updates when
        resampling fires, else None."""
        self._activations_seen_since_last_resample += len(store)
        self.epoch_since_last_resample += 1
        if self._n_times_resampled >= self._max_n_resamples:
            return None

        if self._activations_seen_since_last_resample >= self.neuron_activity_window_start:
            act = np.asarray(batch_neuron_activity)
            if act.ndim > 1:
                act = act.sum(axis=0) if act.shape[0] != self._collated_neuron_activity.shape[0] else act[0]
            self._collated_neuron_activity += act.astype(np.int64)
            self._n_activations_collated_since_last_resample += batch_size

        if (
            self._activations_seen_since_last_resample >= self.neuron_activity_window_end
            and self.epoch_since_last_resample >= self.resample_epoch_freq
        ):
            results = self.resample_dead_neurons(store, params, loss_cfg, batch_size)
            self.epoch_since_last_resample = 0
            self._activations_seen_since_last_resample = 0
            self._n_activations_collated_since_last_resample = 0
            self._n_times_resampled += 1
            self._collated_neuron_activity[:] = 0
            return results
        return None


@torch.no_grad()
def apply_parameter_updates(params: Params, updates: ParameterUpdateResults) -> Params:
    """The params with the resampled neurons written in (component 0 when
    there is a components axis); the input tensors are not modified."""
    if len(updates.dead_neuron_indices) == 0:
        return params
    enc_w = params["encoder"]["weight"].clone()
    enc_b = params["encoder"]["bias"].clone()
    dec_w = params["decoder"]["weight"].clone()
    device = enc_w.device
    dead = torch.as_tensor(updates.dead_neuron_indices, dtype=torch.long, device=device)
    new_enc_w = torch.as_tensor(np.asarray(updates.dead_encoder_weight_updates, np.float32), device=device)
    new_enc_b = torch.as_tensor(np.asarray(updates.dead_encoder_bias_updates, np.float32), device=device)
    new_dec_w = torch.as_tensor(np.asarray(updates.dead_decoder_weight_updates, np.float32), device=device)
    # views of component 0 with a components axis
    ew, eb, dw = (enc_w[0], enc_b[0], dec_w[0]) if enc_w.dim() == 3 else (enc_w, enc_b, dec_w)
    ew[dead], eb[dead], dw[:, dead] = new_enc_w, new_enc_b, new_dec_w
    return {"tied_bias": params["tied_bias"], "encoder": {"weight": enc_w, "bias": enc_b},
            "decoder": {"weight": dec_w}}
