"""PyTorch/CUDA port of xclip_tpu for NVIDIA Hopper (H100).

The JAX package ``xclip_tpu`` is the reference; this package sits beside it,
imports neither ``jax`` nor any module of ``xclip_tpu``, and mirrors its
module names so each counterpart is easy to find. It covers the
ModifiedResNet CLIP models: one-GPU training, the zero-shot DomainNet-LSO
evaluation, sparse-autoencoder training over cached image features, and
the streaming-bandwidth probe.

- ``tokenizer``: the CLIP BPE tokenizer (token-exact copy);
- ``ops``: hand-written CUDA kernels (fused 1x1-conv epilogue, 1x1 conv
  with BatchNorm statistics, flash attention, bf16 stream-and-scale) with
  their plain PyTorch versions, autograd Functions and the nvcc build;
- ``models``: ModifiedResNet image tower (train and eval), text tower, CLIP
  bundle and the config factory, with open_clip state-dict names;
- ``core``: precision policies, device resolution, checkpoint IO;
- ``data``: transforms, datasets and the threaded training loader;
- ``train``: loss, AdamW, schedules, the train step and the CLI
  (``python -m xclip_tpu_torch.train.main``);
- ``evals``: feature extraction, zero-shot classifiers and the LSO evaluator
  (``python -m xclip_tpu_torch.evals.run_lso``);
- ``sae``: the sparse autoencoder, its Adam, resampler, training pipeline
  and feature cache;
- ``scripts``: ``train_sae`` (cache features, train the SAE) and
  ``save_domainnet_features`` (``python -m xclip_tpu_torch.scripts.<name>``);
- ``tools``: ``probe_bandwidth``, the K5 kernel against ``torch.mul``;
- ``assets``: the port's copies of the BPE vocab, eval metadata and model
  configs.

Importing the package builds nothing and touches no GPU.
"""
