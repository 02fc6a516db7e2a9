"""ghostm_tpu_torch — the PyTorch/CUDA port of ghostm_tpu.

Same search, same integers, same m8 bytes as the JAX package, with the
TPU's Pallas kernels replaced by hand-written CUDA C++ kernels for Hopper
(sm_90a) under `csrc/`. Plain PyTorch versions of every kernel sit beside
their wrappers: a CPU tensor goes through the plain version, a CUDA tensor
through the kernel.

The package imports torch and numpy only — never jax and nothing of
ghostm_tpu (tests/test_torch_isolation.py).
"""

__version__ = "0.1.0"

from ghostm_tpu_torch.config import Config  # noqa: F401
