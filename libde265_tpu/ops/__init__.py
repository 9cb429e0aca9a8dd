"""Compute ops: numpy reference implementations + JAX device forms."""
