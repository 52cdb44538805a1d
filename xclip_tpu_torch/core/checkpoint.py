"""Checkpoint IO: open_clip ``.pt`` files, and JAX weights carried across.

- :func:`load_open_clip_checkpoint` reads a ``{"state_dict": ...}``
  checkpoint or a bare state dict and strips DDP's ``module.`` prefix
  (``xclip_tpu/core/checkpoint.py:227-232,776-783``).
- :func:`save_checkpoint` writes a training checkpoint in open_clip's
  format (``epoch``, ``name``, ``state_dict``, ``optimizer`` as
  ``torch.optim``'s ``state_dict()``; reference training/main.py:450-483)
  atomically, and :func:`load_training_checkpoint` reads it back for
  ``--resume``;
- :func:`state_dict_from_jax_params` turns the JAX package's param/state
  pytrees, as nested numpy arrays (``jax.device_get``), into this port's
  state dict: the port's own copy of the ResNet + text mapping of
  ``pytrees_to_open_clip_state_dict`` (checkpoint.py:520-616). HWIO conv
  kernels become OIHW, ``(in, out)`` linear kernels ``(out, in)``, and the
  separate q/k/v projections the packed ``in_proj_*``.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch


def load_open_clip_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """State dict of an open_clip checkpoint, on the CPU, keys without ``module.``."""
    return _state_dict_of(torch.load(path, map_location="cpu", weights_only=True), path)


def _state_dict_of(ckpt, path: str) -> Dict[str, torch.Tensor]:
    sd = ckpt["state_dict"] if isinstance(ckpt, dict) and "state_dict" in ckpt else ckpt
    if not isinstance(sd, Mapping):
        raise ValueError(f"{path}: not a state dict checkpoint")
    if any(k.startswith("module.") for k in sd):
        sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
    sd = dict(sd)
    if "_logit_scale" in sd and "logit_scale" not in sd:
        sd["logit_scale"] = sd.pop("_logit_scale")
    return sd


def save_checkpoint(path: str, model: torch.nn.Module, optimizer: torch.optim.Optimizer, *,
                    epoch: int, name: str = "") -> None:
    """Write ``{"epoch", "name", "state_dict", "optimizer"}`` to ``path``
    through a temporary file and ``os.replace``, so a reader never sees a
    partial file."""
    ckpt = {"epoch": epoch, "name": name,
            "state_dict": {k: v.detach().cpu() for k, v in model.state_dict().items()},
            "optimizer": optimizer.state_dict()}
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)


def load_training_checkpoint(path: str, model: torch.nn.Module,
                             optimizer: Optional[torch.optim.Optimizer] = None) -> dict:
    """Load weights (strict) and, when both sides have it, the optimizer
    state from a checkpoint written by :func:`save_checkpoint` (or by
    open_clip); returns ``{"epoch": ..., "name": ...}`` as stored."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(_state_dict_of(ckpt, path), strict=True)
    if optimizer is not None and isinstance(ckpt, dict) and "optimizer" in ckpt:
        optimizer.load_state_dict(ckpt["optimizer"])
    return {k: ckpt[k] for k in ("epoch", "name") if isinstance(ckpt, dict) and k in ckpt}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)).copy())


def _conv(k) -> torch.Tensor:
    return _t(np.transpose(np.asarray(k), (3, 2, 0, 1)))  # HWIO -> OIHW


def _lin(k) -> torch.Tensor:
    return _t(np.asarray(k).T)  # (in, out) -> (out, in)


def _put_lin(sd, dst, src) -> None:
    sd[f"{dst}.weight"] = _lin(src["kernel"])
    if "bias" in src:
        sd[f"{dst}.bias"] = _t(src["bias"])


def _put_ln(sd, dst, src) -> None:
    sd[f"{dst}.weight"] = _t(src["scale"])
    sd[f"{dst}.bias"] = _t(src["bias"])


def _put_bn(sd, dst, src_p, src_s) -> None:
    sd[f"{dst}.weight"] = _t(src_p["scale"])
    sd[f"{dst}.bias"] = _t(src_p["bias"])
    sd[f"{dst}.running_mean"] = _t(src_s["mean"])
    sd[f"{dst}.running_var"] = _t(src_s["var"])
    sd[f"{dst}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def bottleneck_state_dict(params: Mapping, state: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """State dict of one ``resnet.Bottleneck`` from the JAX block's
    ``(params, state)`` (``resnet._bottleneck_init``)."""
    sd: Dict[str, torch.Tensor] = {}
    for ci in (1, 2, 3):
        sd[f"{prefix}conv{ci}.weight"] = _conv(params[f"conv{ci}"]["kernel"])
        _put_bn(sd, f"{prefix}bn{ci}", params[f"bn{ci}"], state[f"bn{ci}"])
    if "downsample" in params:
        sd[f"{prefix}downsample.0.weight"] = _conv(params["downsample"]["conv"]["kernel"])
        _put_bn(sd, f"{prefix}downsample.1", params["downsample"]["bn"], state["downsample_bn"])
    return sd


def state_dict_from_jax_params(params: Mapping, state: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """Port state dict from JAX ``(params, state)`` of a ResNet CLIP.

    ``params``/``state`` are the pytrees of ``xclip_tpu.models.clip.CLIPModel``
    with numpy leaves; ``cfg`` is this port's ``CLIPCfg`` (or the JAX one:
    only ``vision.layers`` and ``text.layers`` are read).
    """
    sd: Dict[str, torch.Tensor] = {}
    vp, vs = params["visual"], state["visual"]
    for i in (1, 2, 3):
        sd[f"visual.conv{i}.weight"] = _conv(vp["stem"][f"conv{i}"]["kernel"])
        _put_bn(sd, f"visual.bn{i}", vp["stem"][f"bn{i}"], vs["stem"][f"bn{i}"])
    for li, blocks in enumerate(cfg.vision.layers):
        for b in range(blocks):
            sd.update(bottleneck_state_dict(vp[f"layer{li + 1}"][b], vs[f"layer{li + 1}"][b],
                                            prefix=f"visual.layer{li + 1}.{b}."))
    ap = vp["attnpool"]
    sd["visual.attnpool.positional_embedding"] = _t(ap["positional_embedding"])
    for name, dst_name in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("out", "c_proj")):
        _put_lin(sd, f"visual.attnpool.{dst_name}", ap[name])

    tp = params["text"]
    sd["token_embedding.weight"] = _t(tp["token_embedding"])
    sd["positional_embedding"] = _t(tp["positional_embedding"])
    sd["text_projection"] = _t(tp["text_projection"])
    _put_ln(sd, "ln_final", tp["ln_final"])
    for i in range(cfg.text.layers):
        src = tp["blocks"][i]
        dst = f"transformer.resblocks.{i}"
        _put_ln(sd, f"{dst}.ln_1", src["ln_1"])
        attn = src["attn"]
        sd[f"{dst}.attn.in_proj_weight"] = _t(np.concatenate(
            [np.asarray(attn[n]["kernel"]).T for n in ("q", "k", "v")], axis=0))
        sd[f"{dst}.attn.in_proj_bias"] = _t(np.concatenate(
            [np.asarray(attn[n]["bias"]) for n in ("q", "k", "v")]))
        _put_lin(sd, f"{dst}.attn.out_proj", attn["out"])
        _put_ln(sd, f"{dst}.ln_2", src["ln_2"])
        _put_lin(sd, f"{dst}.mlp.c_fc", src["mlp"]["c_fc"])
        _put_lin(sd, f"{dst}.mlp.c_proj", src["mlp"]["c_proj"])
    sd["logit_scale"] = _t(np.asarray(params["logit_scale"]).reshape(()))
    return sd
