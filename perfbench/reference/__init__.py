"""The plain reference of the benchmark: PyTorch and NumPy only, nothing of the program."""
