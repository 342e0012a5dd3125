"""styletts2_tpu_torch: the PyTorch/CUDA port of styletts2_tpu.

Inference on one NVIDIA H100 (`infer.StyleTTS2` with the JAX engine's API;
the HiFi-GAN, iSTFTNet and Vocos decoders) and finetuning (`train_loop`),
with two hand-written CUDA kernels (csrc/) in place of the JAX package's
two Pallas kernels.
Imports torch, never jax, and nothing of the styletts2_tpu package.
"""
