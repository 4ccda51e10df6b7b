"""Plain PyTorch ops and the CUDA kernels of the serving path."""
