"""Device helpers of the PyTorch port."""
