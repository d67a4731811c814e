"""Data (PyTorch): the synthetic 16x16 digits of the applications and the
LMs' synthetic Zipf token pipeline."""
