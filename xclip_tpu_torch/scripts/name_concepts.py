"""Name SAE features by their nearest vocabulary concept (Discover-then-Name).

Counterpart of ``scripts/name_concepts.py``, with its flags plus
``--device``: the vocabulary file's lines are encoded by the CLIP text
tower in fp32 (cached as ``<out_dir>/concepts/embeddings_{vocab}.npy``)
and every SAE feature is named by the concept its unit-norm decoder column
is closest to, into ``<out_dir>/concepts/concept_names.csv``::

    python -m xclip_tpu_torch.scripts.name_concepts --out_dir runs/sae \\
        --vocab_file vocab.txt --ckpt_path epoch_32.pt

The device defaults to CUDA and must be present unless ``--device cpu`` is
given; fp32 without TF32.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from xclip_tpu_torch.core.device import resolve_device
from xclip_tpu_torch.core.precision import disable_tf32
from xclip_tpu_torch.models.factory import create_model
from xclip_tpu_torch.sae.model import sae_state_dict_to_params
from xclip_tpu_torch.sae.naming import DiscoverThenName, embed_vocab
from xclip_tpu_torch.tokenizer import get_tokenizer


def load_sae_params(out_dir: str):
    path = os.path.join(out_dir, "checkpoints", "sparse_autoencoder_final.pt")
    return sae_state_dict_to_params(torch.load(path, map_location="cpu", weights_only=False))


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--img_enc_name", type=str, default="RN50")
    parser.add_argument("--out_dir", type=str, required=True)
    parser.add_argument("--vocab_file", type=str, required=True)
    parser.add_argument("--ckpt_path", type=str, required=True)
    parser.add_argument("--input_dim", type=int, default=1024)
    parser.add_argument("--expansion_factor", type=int, default=4)
    parser.add_argument("--hook_points", nargs="*", default=["out"])
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    disable_tf32()

    vocab_name = os.path.splitext(os.path.split(args.vocab_file)[1])[0]
    emb_path = os.path.join(args.out_dir, "concepts", f"embeddings_{vocab_name}.npy")
    with open(args.vocab_file) as fh:
        concept_names = [line.strip() for line in fh.readlines()]

    if not os.path.exists(emb_path):
        model = create_model(args.img_enc_name, pretrained=args.ckpt_path, precision="fp32",
                             device=resolve_device(args.device))
        emb = embed_vocab(model, get_tokenizer(args.img_enc_name), concept_names)
        os.makedirs(os.path.dirname(emb_path), exist_ok=True)
        np.save(emb_path, emb)
    else:
        emb = np.load(emb_path)

    method = DiscoverThenName(load_sae_params(args.out_dir), emb, concept_names)
    names = method.write_concept_names_csv(os.path.join(args.out_dir, "concepts", "concept_names.csv"))
    for idx, name in enumerate(names[:20]):
        print(f"{idx},{name}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
