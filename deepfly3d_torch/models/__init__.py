"""Model and decode modules of the PyTorch port."""
