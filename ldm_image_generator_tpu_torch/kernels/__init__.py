"""kernels of the PyTorch/CUDA port."""
