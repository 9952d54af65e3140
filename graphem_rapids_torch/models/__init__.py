"""Layout engine of the PyTorch port."""

from .embedder import GraphEmbedderTorch

__all__ = ["GraphEmbedderTorch"]
