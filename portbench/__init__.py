"""The benchmark of the PyTorch and CUDA port (``graphem_rapids_torch``)."""
