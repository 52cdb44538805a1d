"""Integrated-gradients node effects and edge attribution.

Counterpart of ``xclip_tpu/interp/attribution.py`` (the reference's
``attribution.py``: ``_pe_ig`` :22-98 and ``upstream_neuron_attribution``
:272-369). A node effect is the mean gradient of the zero-shot metric with
respect to a submodule's (dictionary-basis) activation along the IG path
from the clean activation toward the patch (zeros when ``patch`` is None),
times the delta. An edge effect is the same for a per-downstream-neuron MSE
metric through one pair of adjacent stages.

JAX scans the IG steps and ``vmap``s the edge metric over the downstream
neurons. Here every IG point (and, for the edges, every neuron's copy of
it) is a sample of one batch: the copies are stacked along the batch axis
and each chunk of them takes one forward and one backward pass. This is
exact because every eval-mode stage is per-sample: eval BatchNorm (running
statistics), the convolutions, the pools and attnpool mix nothing across
the batch. The summed metric is then a sum of terms each of which depends
on one copy only, so its gradient with respect to a copy is that copy's own
gradient. The tower's kernels (K1/K2) launch once per stage and chunk
instead of once per step and neuron.

Chunks are sized from what one copy holds in the forward and backward
pass (:data:`BYTES_PER_ELEMENT`, measured on the card, times the elements
of the segment's stage activations) against :func:`chunk_budget`: a
quarter of the card's memory, or :data:`CPU_CHUNK_BYTES` on the CPU. The
chunking moves no result: each copy's gradient is its own in any chunk.
"""

from __future__ import annotations

from collections import namedtuple
from typing import Dict, List, Sequence

import numpy as np
import torch

from xclip_tpu_torch.interp.dictionary import Dictionary
from xclip_tpu_torch.interp.sparse_act import SparseAct

EffectOut = namedtuple("EffectOut", ["effects", "deltas", "grads", "total_effect"])

# fp32 activation bytes a copy holds per element of its segment's stage
# outputs through the forward and backward (saved tensors, the block's
# intermediates, the gradients in flight), measured: at 24 RN50's circuits
# at 16 images peaked at 36.2 GB against a 21.2 GB budget on an H100 80GB
# (chip_smoke phase 8), 1.7x the estimate; 44 leaves some room above that
BYTES_PER_ELEMENT = 44
CPU_CHUNK_BYTES = 1 << 30


def chunk_budget(device: torch.device) -> int:
    """Bytes one chunk of IG copies may take on ``device``."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory // 4
    return CPU_CHUNK_BYTES


def chunk_sizes(n_copies: int, elements_per_copy: int, device: torch.device) -> List[int]:
    """Sizes of the chunks that ``n_copies`` copies run in: as equal as
    possible, each within the budget."""
    max_copies = max(1, chunk_budget(device) // (BYTES_PER_ELEMENT * max(elements_per_copy, 1)))
    n_chunks = -(-n_copies // max_copies)
    base, extra = divmod(n_copies, n_chunks)
    return [base + (i < extra) for i in range(n_chunks)]


def _chunks(n_copies, elements, device):
    start = 0
    for size in chunk_sizes(n_copies, elements, device):
        yield start, start + size
        start += size


def _alphas(steps: int, device) -> torch.Tensor:
    """alpha = step / steps for step in 0..steps-1, in fp32 as JAX's scan."""
    return torch.arange(steps, dtype=torch.float32, device=device) / steps


def _ig_node_grads(model, name: str, d: Dictionary, clean: SparseAct, patch: SparseAct, label: int, steps: int):
    """Sums over the IG steps of the metric's gradients w.r.t. (act, res),
    each (B, S, *); copy c is step c // B of image c % B."""
    b = clean.act.shape[0]
    device = clean.act.device
    alphas = _alphas(steps, device)
    sum_act, sum_res = torch.zeros_like(clean.act), torch.zeros_like(clean.res)
    for c0, c1 in _chunks(steps * b, model.segment_elements(name), device):
        copy = torch.arange(c0, c1, device=device)
        img = copy % b
        alpha = alphas[copy // b].view(-1, 1, 1)
        pt_act = ((1 - alpha) * clean.act[img] + alpha * patch.act[img]).requires_grad_(True)
        pt_res = ((1 - alpha) * clean.res[img] + alpha * patch.res[img]).requires_grad_(True)
        with torch.enable_grad():
            metric = model.metric_from(name, d.decode(pt_act) + pt_res, label).sum()
            g_act, g_res = torch.autograd.grad(metric, (pt_act, pt_res))
        sum_act.index_add_(0, img, g_act)
        sum_res.index_add_(0, img, g_res)
    return sum_act, sum_res


def _encode_states(acts, submodules, dictionaries) -> Dict[str, SparseAct]:
    states = {}
    for name in submodules:
        d = dictionaries[name]
        x = acts[name]
        f = d.encode(x)
        states[name] = SparseAct(act=f, res=x - d.decode(f))
    return states


@torch.no_grad()
def patching_effect(
    images,
    patch,
    model,  # VisualCircuitModel
    submodules: Sequence[str],
    dictionaries: Dict[str, Dictionary],
    metric_label: int,
    method: str = "ig",
    steps: int = 10,
) -> EffectOut:
    """Node effects for every submodule (reference _pe_ig / patching_effect).

    With IdentityDicts the dictionary basis is the neuron basis and the SAE
    residual is identically zero, so effects live entirely in ``act``.
    """
    if method != "ig":
        raise ValueError(f"Unknown method {method}")

    acts = model.activations(images)
    clean_states = _encode_states(acts, submodules, dictionaries)
    if patch is None:
        patch_states = {k: v.zeros_like() for k, v in clean_states.items()}
        total_effect = None
    else:
        patch_acts = model.activations(patch)
        patch_states = _encode_states(patch_acts, submodules, dictionaries)
        m_clean = model.metric_from(submodules[-1], acts[submodules[-1]], metric_label)
        m_patch = model.metric_from(submodules[-1], patch_acts[submodules[-1]], metric_label)
        total_effect = m_patch - m_clean

    effects, deltas, grads = {}, {}, {}
    for name in submodules:
        clean_state, patch_state = clean_states[name], patch_states[name]
        g_act, g_res = _ig_node_grads(model, name, dictionaries[name], clean_state, patch_state,
                                      metric_label, steps)
        grad = SparseAct(act=g_act / steps, res=g_res / steps)
        delta = (patch_state - clean_state).detach() if patch is not None else (-clean_state).detach()
        effects[name] = grad @ delta
        deltas[name] = delta
        grads[name] = grad
    return EffectOut(effects, deltas, grads, total_effect)


@torch.no_grad()
def upstream_neuron_attribution(
    images,
    patch,
    model,
    upstream: str,
    downstream: str,
    dictionaries: Dict[str, Dictionary],
    upstream_neurons: np.ndarray,
    downstream_neurons: np.ndarray,
    steps: int = 10,
    method: str = "ig",
) -> np.ndarray:
    """Edge effects (n_downstream, n_upstream) between adjacent stages
    (reference attribution.py:272-369): per downstream neuron d, IG of
    MSE(clean_downstream[..., d], downstream(f)[..., d]) over (B, S) w.r.t.
    the upstream activation, contracted against the upstream delta
    (summed over S, averaged over B). Copy c of the batch is downstream
    neuron c // (steps * B), step (c // B) % steps, image c % B.
    """
    if method != "ig":
        raise NotImplementedError(method)

    up_dict, down_dict = dictionaries[upstream], dictionaries[downstream]
    acts = model.activations(images)
    up_x = acts[upstream]
    up_f = up_dict.encode(up_x)
    up_res = up_x - up_dict.decode(up_f)
    down_clean = down_dict.encode(acts[downstream])

    if patch is None:
        # IG toward the zero state; delta = -clean (reference :299-302)
        patch_f, patch_res = torch.zeros_like(up_f), torch.zeros_like(up_res)
    else:
        # IG from the clean toward the patch upstream state; delta = patch - clean
        patch_x = model.activations(patch)[upstream]
        patch_f = up_dict.encode(patch_x)
        patch_res = patch_x - up_dict.decode(patch_f)
    delta = patch_f - up_f

    device = up_f.device
    down_idx = torch.as_tensor(np.asarray(downstream_neurons), dtype=torch.long, device=device)
    b, s_down = down_clean.shape[0], down_clean.shape[1]
    alphas = _alphas(steps, device)
    per_down = torch.zeros((down_idx.numel(), up_f.shape[-1]), dtype=torch.float32, device=device)
    elements = model.segment_elements(upstream, downstream)
    for c0, c1 in _chunks(down_idx.numel() * steps * b, elements, device):
        copy = torch.arange(c0, c1, device=device)
        img, j = copy % b, copy // (steps * b)
        alpha = alphas[(copy // b) % steps].view(-1, 1, 1)
        pt_act = ((1 - alpha) * up_f[img] + alpha * patch_f[img]).requires_grad_(True)
        pt_res = (1 - alpha) * up_res[img] + alpha * patch_res[img]
        neuron = down_idx[j]
        with torch.enable_grad():
            down_f = down_dict.encode(model.run_segment(upstream, downstream, up_dict.decode(pt_act) + pt_res))
            picked = down_f.gather(2, neuron.view(-1, 1, 1).expand(-1, s_down, 1))[..., 0]
            target = down_clean[img].gather(2, neuron.view(-1, 1, 1).expand(-1, s_down, 1))[..., 0]
            metric = ((target - picked) ** 2).sum() / (b * s_down)
            (g_act,) = torch.autograd.grad(metric, (pt_act,))
        per_down.index_add_(0, j, (g_act * delta[img]).sum(dim=1))
    per_down = per_down / steps / b
    return per_down.cpu().numpy()[:, np.asarray(upstream_neurons)]
