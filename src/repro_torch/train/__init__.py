"""Training: the loss, the train step (AdamW, int8 error-feedback
compression, microbatching) and the checkpoint format of the JAX package."""
