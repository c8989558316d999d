"""pupiloptixlab_tpu_torch — the PyTorch/CUDA port of pupiloptixlab_tpu.

The JAX package ``pupiloptixlab_tpu`` is the reference; this package
mirrors its layout (``scene/``, ``flatten/``, ``accel/``, ``render/``,
``world/``, ``system/``, ``passes/``, ``wavefront/``, ``display/``,
``utils/``) module for
module and function for function. Plain PyTorch carries the elementwise
shading math; every Pallas kernel on the ported path has a hand-written
CUDA C++ counterpart for Hopper (``csrc/``), built with nvcc at first use
(``kernels.py``). Each kernel wrapper runs its plain PyTorch version for
tensors on the CPU and launches the kernel for CUDA tensors.

The package stands alone: host-side scene IO (XML, meshes, images), the
math and camera helpers and the native BVH build / OBJ parser are its own
copies (``scene/``, ``utils/``, ``native.py`` with ``csrc/pupil_native.cpp``),
so it imports neither ``jax`` nor any module of the JAX package. Entry
points that make tensors take ``device=None``, which means the CUDA card
(an error where there is none); the CPU is used only where the caller
names it.
"""

__version__ = "0.1.0"
