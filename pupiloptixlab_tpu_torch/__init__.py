"""pupiloptixlab_tpu_torch — the PyTorch/CUDA port of pupiloptixlab_tpu.

The JAX package ``pupiloptixlab_tpu`` is the reference; this package
mirrors its layout (``flatten/``, ``accel/``, ``render/``) module for
module and function for function. Plain PyTorch carries the elementwise
shading math; every Pallas kernel on the ported path has a hand-written
CUDA C++ counterpart for Hopper (``csrc/``), built with nvcc at first use
(``kernels.py``). Each kernel wrapper runs its plain PyTorch version for
tensors on the CPU and launches the kernel for CUDA tensors.

Host-side scene IO (XML, meshes, images) is shared with the reference
package (``pupiloptixlab_tpu.scene`` / ``utils``), whose modules import no
JAX. This package never imports ``jax``.
"""

__version__ = "0.1.0"
