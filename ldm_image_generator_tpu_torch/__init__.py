"""PyTorch/CUDA port of ldm_image_generator_tpu for NVIDIA Hopper.

Mirrors the JAX package's module layout (config, ops, kernels, models,
diffusion, pipelines, cli) and keeps its tensor layouts (NHWC
activations, Dense kernels [in, out], HWIO convs, stacked experts
[E, C, M]) so weights carry across by flattening names (convert.py).

Kernels: every Pallas kernel on the sampling path has a hand-written
sm_90a CUDA counterpart under kernels/csrc, built by kernels/_build.py
on first use. A wrapper takes the plain PyTorch version for a CPU
tensor and launches its kernel (or raises) for a CUDA tensor.
"""
