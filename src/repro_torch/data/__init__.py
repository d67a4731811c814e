"""Data for the applications (PyTorch): the synthetic 16x16 digits."""
