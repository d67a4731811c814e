"""Problems, Glauber primitives and the sampling driver (PyTorch)."""
