"""Tensor ops and the hand-written CUDA kernels of the PyTorch port."""
