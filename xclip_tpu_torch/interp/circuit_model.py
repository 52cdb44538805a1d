"""Stage-addressable circuit model: the RN tower and a frozen zero-shot head.

Counterpart of ``xclip_tpu/interp/circuit_model.py`` (the reference's
nnsight-wrapped classifier, ``compute_circuits.py:33-227``, with the
submodule adapters ``b c h w -> b (h w) c`` and ``b c -> b 1 c``). The
stages are the reference's 22 submodules: the input, the stem's act1-3 and
avgpool, every bottleneck (``resblock1`` ... ``resblock16`` for RN50) and
attnpool. ``activations`` returns all of them in one pass; ``run_from``
resumes the tower from a (modified) stage activation and returns the
zero-shot logits; ``run_segment`` runs the stages between two of them.
Each is a plain function of its input tensor, so autograd differentiates it
(``interp.attribution``).

The adapter layout ``(B, S, C)`` is JAX's NHWC row-major order, ``S = h*W +
w``: the port's channels-last NCHW activations are permuted to NHWC before
the reshape and back after it. The tower runs in eval mode, fp32, with its
parameters frozen (``requires_grad`` off): attribution differentiates the
activations only.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from xclip_tpu_torch.models.clip import l2_normalize
from xclip_tpu_torch.models.resnet import EXPANSION, resnet_stage_names


@dataclasses.dataclass(frozen=True)
class StageInfo:
    name: str
    index: int  # index into resnet_stage_names; -1 = model input
    spatial: int  # H (= W) of the activation; 0 for vector stages
    channels: int

    @property
    def elements(self) -> int:
        """Elements of one image's activation."""
        return self.channels * max(self.spatial, 1) ** 2


class VisualCircuitModel:
    """RN tower of ``model`` (a port ``CLIP``) + the frozen zero-shot text
    head ``text_features`` ((classes, E), unit rows), on the model's device."""

    def __init__(self, model, text_features):
        if not model.cfg.is_resnet:
            raise ValueError("circuit analysis targets the RN towers")
        self.model = model.eval().requires_grad_(False)
        self.visual = model.visual
        self.cfg = model.cfg.vision
        self.device = next(model.parameters()).device
        self.text_features = torch.as_tensor(np.asarray(text_features, np.float32), device=self.device)

        g = self.cfg.image_size
        stages: List[StageInfo] = [StageInfo("input", -1, g, 3)]
        self.stage_names = resnet_stage_names(self.cfg)
        w = self.cfg.width
        hw = g // 2
        channels = {"stem.act1": w // 2, "stem.act2": w // 2, "stem.act3": w, "stem.avgpool": w}
        for i, name in enumerate(self.stage_names):
            if name.startswith("stem"):
                if name == "stem.avgpool":
                    hw = g // 4
                stages.append(StageInfo(name.replace("stem.", ""), i, hw, channels[name]))
            elif name.startswith("layer"):
                stage_idx = int(name.split(".")[0][-1])
                block = int(name.split(".")[1])
                if block == 0 and stage_idx > 1:
                    hw = hw // 2
                stages.append(StageInfo(f"resblock{self._block_number(stage_idx, block)}", i, hw,
                                        w * (2 ** (stage_idx - 1)) * EXPANSION))
            else:  # attnpool
                stages.append(StageInfo("attnpool", i, 0, self.cfg.output_dim))
        self.stages = stages
        self.name_to_stage = {s.name: s for s in stages}

    def _block_number(self, stage_idx: int, block: int) -> int:
        return sum(self.cfg.layers[: stage_idx - 1]) + block + 1

    def segment_elements(self, upstream: str, downstream: str = "attnpool") -> int:
        """Elements per image that a pass from ``upstream``'s activation to
        ``downstream``'s holds: the input and every stage output between."""
        up, down = self.name_to_stage[upstream], self.name_to_stage[downstream]
        return sum(s.elements for s in self.stages if up.index <= s.index <= down.index)

    # ------------------------------------------------------------------
    @staticmethod
    def _to_tokens(x: torch.Tensor, nhwc: bool = False) -> torch.Tensor:
        """Activation -> (B, S, C) with S = h*W + w; vectors -> (B, 1, C)."""
        if x.dim() == 4:
            if not nhwc:
                x = x.permute(0, 2, 3, 1)  # NCHW -> NHWC
            b, h, w, c = x.shape
            return x.reshape(b, h * w, c)
        return x[:, None, :]

    @staticmethod
    def _from_tokens(tokens: torch.Tensor, stage: StageInfo) -> torch.Tensor:
        """(B, S, C) -> the stage's activation: the NHWC image for the
        input, NCHW (channels_last) for the other spatial stages."""
        if stage.spatial == 0:
            return tokens[:, 0, :]
        b, _, c = tokens.shape
        x = tokens.reshape(b, stage.spatial, stage.spatial, c)
        return x if stage.index < 0 else x.permute(0, 3, 1, 2)

    def as_input(self, images) -> torch.Tensor:
        """Images (numpy or tensor, NHWC) as an fp32 tensor on the model's device."""
        return torch.as_tensor(np.asarray(images, np.float32) if not torch.is_tensor(images) else images,
                               device=self.device)

    @torch.no_grad()
    def activations(self, images) -> Dict[str, torch.Tensor]:
        """All stage activations in the (B, S, C) layout, one pass."""
        images = self.as_input(images)
        _, inters = self.visual.run_stages(images, capture=self.stage_names)
        out = {"input": self._to_tokens(images, nhwc=True)}
        for info in self.stages[1:]:
            out[info.name] = self._to_tokens(inters[self.stage_names[info.index]])
        return out

    def run_from(self, stage_name: str, tokens: torch.Tensor) -> torch.Tensor:
        """Resume the tower from stage ``stage_name``'s (modified) activation
        -> zero-shot logits (B, classes)."""
        stage = self.name_to_stage[stage_name]
        x = self._from_tokens(tokens, stage)
        if stage.name != "attnpool":
            x, _ = self.visual.run_stages(x, start=stage.index + 1)
        feats = l2_normalize(x.float())
        return feats @ self.text_features.t()

    def run_segment(self, upstream: str, downstream: str, tokens: torch.Tensor) -> torch.Tensor:
        """Downstream activation (B, S, C) given the upstream activation."""
        up = self.name_to_stage[upstream]
        down = self.name_to_stage[downstream]
        x = self._from_tokens(tokens, up)
        out, _ = self.visual.run_stages(x, start=up.index + 1, stop=down.index + 1)
        return self._to_tokens(out)

    def metric_from(self, stage_name: str, tokens: torch.Tensor, label: int) -> torch.Tensor:
        """Per-sample zero-shot logit of ``label`` (the reference metric_fn,
        compute_circuits.py:276-279), resumed from a stage activation."""
        return self.run_from(stage_name, tokens)[:, label]
