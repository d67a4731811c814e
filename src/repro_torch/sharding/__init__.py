"""Logical-axis sharding on DTensor (`partition`)."""
