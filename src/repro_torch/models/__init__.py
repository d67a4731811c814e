"""Decoder-only LMs for serving: layers, attention, MoE, the decoder stack,
the model and the weights carried across from the JAX package."""
