"""PyTorch/CUDA port of multimodal_outage_tpu for one NVIDIA H100.

The JAX package beside this one stays the reference. This package imports
torch and numpy only, never jax or any module of multimodal_outage_tpu.
Its kernels are hand-written CUDA C++ for sm_90a under csrc/, compiled
with nvcc at first use (ops/_build.py). Entry points run on the card
unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
