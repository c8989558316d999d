"""The plain reference: a frozen copy of the port's plain CPU path
(scene loader, flatten, shading) with brute-force intersection, which
imports nothing of the port, the JAX package or JAX. Its entry is
``pixels.py``."""
