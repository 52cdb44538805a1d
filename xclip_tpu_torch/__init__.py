"""PyTorch/CUDA port of xclip_tpu for NVIDIA Hopper (H100).

The JAX package ``xclip_tpu`` is the reference; this package sits beside it,
imports neither ``jax`` nor any module of ``xclip_tpu``, and mirrors its
module names so each counterpart is easy to find. This slice covers the
zero-shot DomainNet-LSO evaluation of the ModifiedResNet CLIP models:

- ``tokenizer``: the CLIP BPE tokenizer (token-exact copy);
- ``ops``: hand-written CUDA kernels (fused 1x1-conv epilogue, flash
  attention) with their plain PyTorch versions and the nvcc build;
- ``models``: ModifiedResNet image tower (eval mode), text tower, CLIP
  bundle and the config factory, with open_clip state-dict names;
- ``core``: precision policies, device resolution, checkpoint IO;
- ``data``: eval transform and the ImageNet / DomainNet indexes;
- ``evals``: feature extraction, zero-shot classifiers and the LSO evaluator
  (``python -m xclip_tpu_torch.evals.run_lso``).

Importing the package builds nothing and touches no GPU.
"""
