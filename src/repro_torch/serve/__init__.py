"""The continuous-batching serving engine."""
