"""Sparse autoencoder over cached CLIP features: model, losses, metrics,
Adam with moment reset, the dead-neuron resampler, the training pipeline
and the feature cache (counterparts of ``xclip_tpu/sae``)."""
