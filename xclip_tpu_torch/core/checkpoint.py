"""Checkpoint IO: open_clip ``.pt`` files, and JAX weights carried across.

- :func:`load_open_clip_checkpoint` reads a ``{"state_dict": ...}``
  checkpoint or a bare state dict and strips DDP's ``module.`` prefix
  (``xclip_tpu/core/checkpoint.py:227-232,776-783``).
- :func:`save_checkpoint` writes a training checkpoint in open_clip's
  format (``epoch``, ``name``, ``state_dict``, ``optimizer`` as
  ``torch.optim``'s ``state_dict()``; reference training/main.py:450-483)
  atomically, and :func:`load_training_checkpoint` reads it back for
  ``--resume``;
- :func:`resize_pos_embeds` resamples a checkpoint's positional embeddings
  to the model's grid and context length, as JAX's loader does
  (``_resize_vit_pos_embed`` and ``_resize_text_pos_embed``,
  checkpoint.py:253-275,389-403): ``create_model(pretrained=...)`` and
  :func:`load_training_checkpoint` apply it, so a 224-px ``.pt`` loads
  under ``--force-image-size``;
- :func:`state_dict_from_jax_params` turns the JAX package's param/state
  pytrees, as nested numpy arrays (``jax.device_get``), into this port's
  state dict: the port's own copy of the ResNet, ViT and text mapping of
  ``pytrees_to_open_clip_state_dict`` (checkpoint.py:520-646). HWIO conv
  kernels become OIHW, ``(in, out)`` linear kernels ``(out, in)``, the
  separate q/k/v projections the packed ``in_proj_*`` (the attentional
  pooler's stay separate when its key width differs, as in
  ``nn.MultiheadAttention``), LayerScale gammas ``ls_1.gamma``/``ls_2.gamma``;
  a timm image tower (ConvNeXt, EVA, timm ViT) through its family's bridge
  in ``models/native_timm.py`` (``visual.trunk.*``, ``visual.head.*``), a
  ``custom_text`` tower under ``text.`` (checkpoint.py:409-410, 574-576)
  with its ``nn.Linear`` projection where ``proj_bias`` is set, and
  ``logit_bias``;
- the JAX package's native ``.npz`` format (``flatten_pytree``,
  ``unflatten_into``, ``save_native``, ``load_native``; checkpoint.py:42-112,
  652-684), in which the supervised classifier is saved: its weights cross
  between the port's state dict and JAX's ``learner.Classifier`` pytrees
  both ways (:func:`classifier_pytrees_from_state_dict`,
  :func:`classifier_state_dict_from_pytrees`), so a checkpoint written by
  either package loads in the other.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

# the linear and LayerNorm layouts, shared with the timm towers' bridges
from xclip_tpu_torch.models.tower_common import array, read_linear, read_ln, tensor, write_linear, write_ln


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
    model.load_state_dict(resize_pos_embeds(_state_dict_of(ckpt, path), model.cfg), strict=True)
    if optimizer is not None and isinstance(ckpt, dict) and "optimizer" in ckpt:
        optimizer.load_state_dict(ckpt["optimizer"])
    return {k: ckpt[k] for k in ("epoch", "name") if isinstance(ckpt, dict) and k in ckpt}


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel with a = -0.5 at |x| (``jax.image``'s
    bicubic; PyTorch's bicubic without antialiasing uses a = -0.75)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _bicubic_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) resampling weights of ``jax.image.resize(...,
    method="bicubic")`` (``scale_and_translate`` with antialiasing, no
    translation): half-pixel centres, the kernel widened by n_in / n_out
    when shrinking, each output's weights normalised to sum 1 (so taps past
    the edge drop out instead of clamping)."""
    inv_scale = n_in / n_out
    sample = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    w = _keys_cubic(np.abs(sample[None, :] - np.arange(n_in)[:, None]) / max(inv_scale, 1.0))
    total = w.sum(axis=0, keepdims=True)
    return np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps, w / np.where(total != 0, total, 1), 0.0)


def resize_vit_pos_embed(pe: torch.Tensor, seq_len: int) -> torch.Tensor:
    """A ViT's (1 + g^2, width) positional embedding at ``seq_len`` = 1 +
    n^2 rows: the class token kept, the g x g grid resampled bicubically to
    n x n as JAX's ``_resize_vit_pos_embed`` does (open_clip's own
    ``resize_pos_embed`` uses a = -0.75 and differs slightly)."""
    if pe.shape[0] == seq_len:
        return pe
    tok, grid = pe[:1], pe[1:]
    old, new = math.isqrt(grid.shape[0]), math.isqrt(seq_len - 1)
    if old * old != grid.shape[0] or new * new != seq_len - 1:
        raise ValueError(f"cannot resize pos embed {pe.shape[0]} -> {seq_len}: non-square grid")
    w = torch.from_numpy(_bicubic_weights(old, new))
    out = torch.einsum("hwc,hy,wx->yxc", grid.double().reshape(old, old, -1), w, w)
    return torch.cat([tok, out.reshape(new * new, -1).to(pe.dtype)])


def resize_text_pos_embed(pe: torch.Tensor, context_length: int) -> torch.Tensor:
    """The text positional embedding resampled linearly to
    ``context_length`` rows (``align_corners=False``, clamped at the ends),
    as JAX's ``_resize_text_pos_embed`` does."""
    old = pe.shape[0]
    if old == context_length:
        return pe
    coords = np.clip((np.arange(context_length) + 0.5) * (old / context_length) - 0.5, 0, old - 1)
    lo = np.floor(coords).astype(np.int64)
    hi = np.minimum(lo + 1, old - 1)
    frac = torch.from_numpy((coords - lo).astype(np.float32))[:, None]
    out = pe[torch.from_numpy(lo)].float() * (1.0 - frac) + pe[torch.from_numpy(hi)].float() * frac
    return out.to(pe.dtype)


def resize_pos_embeds(sd: Dict[str, torch.Tensor], cfg) -> Dict[str, torch.Tensor]:
    """``sd`` with its ViT and text positional embeddings (inline or under
    ``text.``) resampled to ``cfg``'s (the port's ``CLIPCfg``) grid and
    context length, in place. A timm trunk's ``pos_embed`` is left as it
    is, as JAX's loader leaves it."""
    if "visual.positional_embedding" in sd:
        sd["visual.positional_embedding"] = resize_vit_pos_embed(sd["visual.positional_embedding"],
                                                                 cfg.vision.seq_len)
    for key in ("positional_embedding", "text.positional_embedding"):
        if key in sd:
            sd[key] = resize_text_pos_embed(sd[key], cfg.text.context_length)
    return sd


def _conv(k) -> torch.Tensor:
    return tensor(np.transpose(np.asarray(k), (3, 2, 0, 1)))  # HWIO -> OIHW


def _put_bn(sd, dst, src_p, src_s) -> None:
    sd[f"{dst}.weight"] = tensor(src_p["scale"])
    sd[f"{dst}.bias"] = tensor(src_p["bias"])
    sd[f"{dst}.running_mean"] = tensor(src_s["mean"])
    sd[f"{dst}.running_var"] = tensor(src_s["var"])
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


def _put_block(sd, dst, src) -> None:
    """One residual attention block (``transformer.block_init``)."""
    write_ln(sd, f"{dst}.ln_1", src["ln_1"])
    attn = src["attn"]
    sd[f"{dst}.attn.in_proj_weight"] = tensor(np.concatenate(
        [np.asarray(attn[n]["kernel"]).T for n in ("q", "k", "v")], axis=0))
    sd[f"{dst}.attn.in_proj_bias"] = tensor(np.concatenate([np.asarray(attn[n]["bias"]) for n in ("q", "k", "v")]))
    write_linear(sd, f"{dst}.attn.out_proj", attn["out"])
    write_ln(sd, f"{dst}.ln_2", src["ln_2"])
    write_linear(sd, f"{dst}.mlp.c_fc", src["mlp"]["c_fc"])
    write_linear(sd, f"{dst}.mlp.c_proj", src["mlp"]["c_proj"])
    for ls in ("ls_1", "ls_2"):
        if ls in src:
            sd[f"{dst}.{ls}.gamma"] = tensor(src[ls])


def _vit_state_dict(vp: Mapping) -> Dict[str, torch.Tensor]:
    """``visual.*`` of a ViT tower from JAX's ``vit_init`` params."""
    sd: Dict[str, torch.Tensor] = {
        "visual.conv1.weight": _conv(vp["conv1"]["kernel"]),
        "visual.class_embedding": tensor(vp["class_embedding"]),
        "visual.positional_embedding": tensor(vp["positional_embedding"]),
        "visual.proj": tensor(vp["proj"]),
    }
    if "ln_pre" in vp:  # absent for no_ln_pre towers
        write_ln(sd, "visual.ln_pre", vp["ln_pre"])
    write_ln(sd, "visual.ln_post", vp["ln_post"])
    for i, block in enumerate(vp["blocks"]):
        _put_block(sd, f"visual.transformer.resblocks.{i}", block)
    if "attn_pool" in vp:
        ap = vp["attn_pool"]
        sd["visual.attn_pool.query"] = tensor(ap["query"])
        w = {n: np.asarray(ap["attn"][n]["kernel"]).T for n in ("q", "k", "v")}
        if w["q"].shape == w["k"].shape == w["v"].shape:
            sd["visual.attn_pool.attn.in_proj_weight"] = tensor(np.concatenate([w["q"], w["k"], w["v"]]))
        else:
            for n in ("q", "k", "v"):
                sd[f"visual.attn_pool.attn.{n}_proj_weight"] = tensor(w[n])
        sd["visual.attn_pool.attn.in_proj_bias"] = tensor(np.concatenate(
            [np.asarray(ap["attn"][n]["bias"]) for n in ("q", "k", "v")]))
        write_linear(sd, "visual.attn_pool.attn.out_proj", ap["attn"]["out"])
        write_ln(sd, "visual.attn_pool.ln_q", ap["ln_q"])
        write_ln(sd, "visual.attn_pool.ln_k", ap["ln_k"])
    return sd


def visual_state_dict_from_jax(vp: Mapping, vs: Optional[Mapping], cfg) -> Dict[str, torch.Tensor]:
    """``visual.*`` of the port's state dict from the JAX image tower's
    params ``vp`` and state ``vs`` (a ResNet's BatchNorm statistics; unread
    for a ViT); ``cfg`` as in :func:`state_dict_from_jax_params`."""
    sd: Dict[str, torch.Tensor] = {}
    if isinstance(cfg.vision.layers, (list, tuple)):
        for i in (1, 2, 3):
            sd[f"visual.conv{i}.weight"] = _conv(vp["stem"][f"conv{i}"]["kernel"])
            _put_bn(sd, f"visual.bn{i}", vp["stem"][f"bn{i}"], vs["stem"][f"bn{i}"])
        for li, blocks in enumerate(cfg.vision.layers):
            for b in range(blocks):
                sd.update(bottleneck_state_dict(vp[f"layer{li + 1}"][b], vs[f"layer{li + 1}"][b],
                                                prefix=f"visual.layer{li + 1}.{b}."))
        ap = vp["attnpool"]
        sd["visual.attnpool.positional_embedding"] = tensor(ap["positional_embedding"])
        for name, dst_name in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("out", "c_proj")):
            write_linear(sd, f"visual.attnpool.{dst_name}", ap[name])
    else:
        sd.update(_vit_state_dict(vp))
    return sd


def state_dict_from_jax_params(params: Mapping, state: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """Port state dict from JAX ``(params, state)`` of a CLIP.

    ``params``/``state`` are the pytrees of ``xclip_tpu.models.clip.CLIPModel``
    with numpy leaves; ``cfg`` is this port's ``CLIPCfg`` (for a ResNet or a
    plain ViT the JAX one also serves: only ``vision.layers``,
    ``text.layers`` and ``custom_text`` are read there; ``state`` only for a
    ResNet).
    """
    from xclip_tpu_torch.models import native_timm

    if native_timm.is_native_timm(cfg.vision):
        sd = {f"visual.{k}": v for k, v in native_timm.params_to_state_dict(params["visual"], cfg.vision).items()}
    else:
        resnet = isinstance(cfg.vision.layers, (list, tuple))
        sd = visual_state_dict_from_jax(params["visual"], state["visual"] if resnet else None, cfg)
    tp = params["text"]
    pre = "text." if getattr(cfg, "custom_text", False) else ""
    sd[f"{pre}token_embedding.weight"] = tensor(tp["token_embedding"])
    sd[f"{pre}positional_embedding"] = tensor(tp["positional_embedding"])
    if isinstance(tp["text_projection"], Mapping):  # proj_bias: an nn.Linear
        write_linear(sd, f"{pre}text_projection", tp["text_projection"])
    else:
        sd[f"{pre}text_projection"] = tensor(tp["text_projection"])
    write_ln(sd, f"{pre}ln_final", tp["ln_final"])
    for i in range(cfg.text.layers):
        _put_block(sd, f"{pre}transformer.resblocks.{i}", tp["blocks"][i])
    sd["logit_scale"] = tensor(np.asarray(params["logit_scale"]).reshape(()))
    if "logit_bias" in params:
        sd["logit_bias"] = tensor(np.asarray(params["logit_bias"]).reshape(()))
    return sd


# --- the JAX package's native checkpoint format (.npz + JSON extras) -------

SEP = "/"


def flatten_pytree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts and lists -> ``{"a/b/0/c": array}`` (``checkpoint.flatten_pytree``)."""
    out: Dict[str, np.ndarray] = {}

    def rec(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(v, f"{path}{SEP}{k}" if path else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(v, f"{path}{SEP}{i}" if path else str(i))
        else:
            out[path] = np.asarray(node)

    rec(tree, prefix)
    return out


def unflatten_into(tree, flat: Mapping[str, np.ndarray]):
    """``tree`` with every leaf replaced by ``flat``'s value at its path, cast
    to the leaf's dtype; raises on a missing path or another shape, as
    ``checkpoint.unflatten_into`` does."""

    def rec(node, path):
        if isinstance(node, dict):
            return {k: rec(v, f"{path}{SEP}{k}" if path else str(k)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            seq = [rec(v, f"{path}{SEP}{i}" if path else str(i)) for i, v in enumerate(node)]
            return type(node)(seq) if isinstance(node, tuple) else seq
        if path not in flat:
            raise KeyError(f"checkpoint missing key {path}")
        val = np.asarray(flat[path])
        if tuple(val.shape) != tuple(np.shape(node)):
            raise ValueError(f"shape mismatch for {path}: ckpt {val.shape} vs model {np.shape(node)}")
        return val.astype(np.asarray(node).dtype)

    return rec(tree, "")


def save_native(path: str, params, state, extras: Optional[dict] = None) -> None:
    """Write param and state pytrees (nested dicts and lists of arrays) to
    one ``.npz`` with the keys ``params/...`` and ``state/...`` and the
    ``extras`` JSON as the uint8 array ``__extras__``, through ``.tmp`` and
    ``os.replace`` (``checkpoint.save_native``)."""
    flat = {"params" + SEP + k: v for k, v in flatten_pytree(params).items()}
    flat.update({"state" + SEP + k: v for k, v in flatten_pytree(state).items()})
    header = json.dumps(extras or {})
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, __extras__=np.frombuffer(header.encode(), dtype=np.uint8), **flat)
    os.replace(tmp, path)


def load_native(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray], dict]:
    """A native checkpoint as flat ``(params, state, extras)``, the paths
    without their ``params/`` and ``state/`` prefixes."""
    with np.load(path) as npz:
        flat = {k: npz[k] for k in npz.files}
    extras = json.loads(flat.pop("__extras__").tobytes().decode()) if "__extras__" in flat else {}
    pflat = {k[len("params") + 1:]: v for k, v in flat.items() if k.startswith("params" + SEP)}
    sflat = {k[len("state") + 1:]: v for k, v in flat.items() if k.startswith("state" + SEP)}
    return pflat, sflat, extras


def _get_conv(sd, name: str) -> dict:
    return {"kernel": np.transpose(array(sd[name]), (2, 3, 1, 0)).copy()}  # OIHW -> HWIO


def _get_bn_stats(sd, name: str) -> dict:
    return {"mean": array(sd[f"{name}.running_mean"]), "var": array(sd[f"{name}.running_var"])}


def visual_pytrees_from_state_dict(sd: Mapping[str, torch.Tensor], cfg) -> Tuple[dict, dict]:
    """The JAX image tower's ``(params, state)`` pytrees (numpy leaves) from
    the port's ``visual.*`` weights: the inverse of
    :func:`visual_state_dict_from_jax`, with the paths and shapes of JAX's
    ``resnet_init`` / ``vit_init`` (the visual half of
    ``checkpoint.open_clip_state_dict_to_pytrees``). A ViT has no state."""
    if not isinstance(cfg.vision.layers, (list, tuple)):
        if "visual.attn_pool.query" in sd:
            raise NotImplementedError("the attentional pooler has no JAX pytree bridge in the port")
        width = cfg.vision.width
        vp = {"conv1": _get_conv(sd, "visual.conv1.weight"),
              "class_embedding": array(sd["visual.class_embedding"]),
              "positional_embedding": array(sd["visual.positional_embedding"]),
              "blocks": [], "ln_post": read_ln(sd, "visual.ln_post"), "proj": array(sd["visual.proj"])}
        if "visual.ln_pre.weight" in sd:
            vp["ln_pre"] = read_ln(sd, "visual.ln_pre")
        for i in range(cfg.vision.layers):
            src = f"visual.transformer.resblocks.{i}"
            w, b = array(sd[f"{src}.attn.in_proj_weight"]), array(sd[f"{src}.attn.in_proj_bias"])
            attn = {n: {"kernel": w[j * width:(j + 1) * width].T.copy(), "bias": b[j * width:(j + 1) * width]}
                    for j, n in enumerate(("q", "k", "v"))}
            attn["out"] = read_linear(sd, f"{src}.attn.out_proj")
            block = {"ln_1": read_ln(sd, f"{src}.ln_1"), "attn": attn,
                     "ln_2": read_ln(sd, f"{src}.ln_2"),
                     "mlp": {"c_fc": read_linear(sd, f"{src}.mlp.c_fc"), "c_proj": read_linear(sd, f"{src}.mlp.c_proj")}}
            for ls in ("ls_1", "ls_2"):
                if f"{src}.{ls}.gamma" in sd:
                    block[ls] = array(sd[f"{src}.{ls}.gamma"])
            vp["blocks"].append(block)
        return vp, {}
    vp: dict = {"stem": {}}
    vs: dict = {"stem": {}}
    for i in (1, 2, 3):
        vp["stem"][f"conv{i}"] = _get_conv(sd, f"visual.conv{i}.weight")
        vp["stem"][f"bn{i}"] = read_ln(sd, f"visual.bn{i}")
        vs["stem"][f"bn{i}"] = _get_bn_stats(sd, f"visual.bn{i}")
    for li, blocks in enumerate(cfg.vision.layers):
        vp[f"layer{li + 1}"], vs[f"layer{li + 1}"] = [], []
        for b in range(blocks):
            src = f"visual.layer{li + 1}.{b}"
            bp, bs = {}, {}
            for ci in (1, 2, 3):
                bp[f"conv{ci}"] = _get_conv(sd, f"{src}.conv{ci}.weight")
                bp[f"bn{ci}"] = read_ln(sd, f"{src}.bn{ci}")
                bs[f"bn{ci}"] = _get_bn_stats(sd, f"{src}.bn{ci}")
            if f"{src}.downsample.0.weight" in sd:
                bp["downsample"] = {"conv": _get_conv(sd, f"{src}.downsample.0.weight"),
                                    "bn": read_ln(sd, f"{src}.downsample.1")}
                bs["downsample_bn"] = _get_bn_stats(sd, f"{src}.downsample.1")
            vp[f"layer{li + 1}"].append(bp)
            vs[f"layer{li + 1}"].append(bs)
    vp["attnpool"] = {"positional_embedding": array(sd["visual.attnpool.positional_embedding"])}
    for name, src_name in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("out", "c_proj")):
        vp["attnpool"][name] = read_linear(sd, f"visual.attnpool.{src_name}")
    return vp, vs


def classifier_pytrees_from_state_dict(sd: Mapping[str, torch.Tensor], cfg) -> Tuple[dict, dict]:
    """The JAX ``learner.Classifier``'s ``({"backbone", "head"}, {"visual"})``
    pytrees from the port classifier's state dict (``visual.*``, ``head.*``);
    ``cfg`` is the backbone's ``CLIPCfg``."""
    vp, vs = visual_pytrees_from_state_dict(sd, cfg)
    return {"backbone": vp, "head": read_linear(sd, "head")}, {"visual": vs}


def classifier_state_dict_from_pytrees(params: Mapping, state: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """The port classifier's state dict from the JAX classifier's pytrees:
    the inverse of :func:`classifier_pytrees_from_state_dict` (BatchNorm
    ``num_batches_tracked`` is 0: JAX keeps no count)."""
    resnet = isinstance(cfg.vision.layers, (list, tuple))
    sd = visual_state_dict_from_jax(params["backbone"], state["visual"] if resnet else None, cfg)
    write_linear(sd, "head", params["head"])
    return sd
