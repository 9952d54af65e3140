"""Step and host-preparation ops of the PyTorch port."""
