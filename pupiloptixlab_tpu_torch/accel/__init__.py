"""Acceleration structures and the traversal / gather kernels' wrappers."""
