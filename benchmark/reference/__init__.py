"""The plain reference that decides `correct`: StyleTTS2-lite inference
(text front end, style, phase 1, duration glue, phase 2 with HiFi-GAN or
Vocos, int16 PCM) in plain PyTorch and NumPy, one utterance at a time at
its exact length, float32 with TF32 off.

It imports nothing of styletts2_tpu_torch, styletts2_tpu or jax, and works
out again from the benchmark's inputs (the raw weight tree, the clip, the
texts, the seeds) whatever the program derives from them: fused weight
norm, prepacked weights, buckets, durations and their rounding.
"""
