"""diffusion of the PyTorch/CUDA port."""
