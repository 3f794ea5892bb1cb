"""cli of the PyTorch/CUDA port."""
