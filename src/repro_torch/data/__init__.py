"""Synthetic Earth-observation tasks (numpy) and region tiling (tensors)."""
