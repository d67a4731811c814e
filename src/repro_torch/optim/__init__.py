"""AdamW, the learning-rate schedules and int8 gradient compression with
error feedback, by hand as in the JAX package."""
