"""Model factory: the JSON config registry and ``create_model``.

Counterpart of ``xclip_tpu/models/factory.py``. The open_clip JSON configs
are the port's copies in ``assets/model_configs`` (``_assets``).
``create_model`` returns one ``nn.Module`` in eval mode on the requested
device; the ResNet configs (RN50, RN101, RN50x4, RN50x16, RN50x64 and their
-quickgelu variants), the plain ViT configs (ViT-S/M/B/L/H/g/bigG/e and
the CLIPA towers) and the timm-tower configs of the ConvNeXt, EVA01/EVA02
and timm-ViT families (the SigLIP towers, the gap and relpos medium ViTs)
without an HF text tower are built. ``force_image_size`` and
``force_patch_dropout`` override the config as the JAX factory does
(:50-62), timm towers included; a checkpoint of
another grid or context length loads with its positional embeddings
resampled as JAX's loader does (``core.checkpoint.resize_pos_embeds``).
"""

from __future__ import annotations

import json
from copy import deepcopy
from typing import Dict, Optional, Union

import torch

from xclip_tpu_torch._assets import MODEL_CONFIG_DIR
from xclip_tpu_torch.core.device import resolve_device
from xclip_tpu_torch.core.precision import get_policy
from xclip_tpu_torch.models.clip import CLIP, CLIPCfg, clip_cfg_from_dict


def _scan_model_configs() -> Dict[str, dict]:
    configs = {}
    for path in sorted(MODEL_CONFIG_DIR.glob("*.json")):
        cfg = json.loads(path.read_text())
        if "embed_dim" in cfg and "vision_cfg" in cfg and "text_cfg" in cfg:
            configs[path.stem] = cfg
    return configs


_MODEL_CONFIGS: Dict[str, dict] = _scan_model_configs()


def list_models():
    return list(_MODEL_CONFIGS)


def get_model_config(model_name: str) -> Optional[dict]:
    cfg = _MODEL_CONFIGS.get(model_name)
    return deepcopy(cfg) if cfg is not None else None


def get_clip_cfg(model_name: str, force_image_size: Optional[int] = None,
                 force_patch_dropout: Optional[float] = None) -> CLIPCfg:
    cfg = get_model_config(model_name)
    if cfg is None:
        raise RuntimeError(f"Model config for {model_name} not found; available: {list_models()}")
    if force_image_size is not None:
        cfg["vision_cfg"]["image_size"] = force_image_size
    if force_patch_dropout is not None:
        cfg["vision_cfg"]["patch_dropout"] = force_patch_dropout
    return clip_cfg_from_dict(cfg)


def create_model(
    model_name: str,
    pretrained: Optional[str] = None,
    precision: str = "fp32",
    device: Union[str, torch.device] = "cuda",
    seed: int = 0,
    force_image_size: Optional[int] = None,
    force_patch_dropout: Optional[float] = None,
) -> CLIP:
    """Build ``model_name`` in eval mode on ``device``.

    Weights come from the open_clip ``.pt`` at ``pretrained`` when one is
    given, else from ``torch.Generator().manual_seed(seed)`` on the CPU
    (the same numbers on every device). ``device`` defaults to CUDA
    and raises when there is none; pass ``device="cpu"`` for the CPU.
    """
    dev = resolve_device(device)
    cfg = get_clip_cfg(model_name, force_image_size, force_patch_dropout)
    with torch.device("meta"):
        model = CLIP(cfg)
    model = model.to_empty(device="cpu")
    if pretrained:
        # strict: every parameter and buffer comes from the checkpoint
        from xclip_tpu_torch.core.checkpoint import load_open_clip_checkpoint, resize_pos_embeds

        model.load_state_dict(resize_pos_embeds(load_open_clip_checkpoint(pretrained), cfg), strict=True)
    else:
        model.init_parameters(torch.Generator().manual_seed(seed))
    param_dtype = get_policy(precision).param_dtype
    if param_dtype != torch.float32:
        for p in model.parameters():
            p.data = p.data.to(param_dtype)
    return model.to(dev).eval()
