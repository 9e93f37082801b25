"""PyTorch / CUDA port of mpcium_tpu for NVIDIA Hopper GPUs.

A package of its own beside ``mpcium_tpu`` (the JAX reference, which it
never imports). Layout mirrors the JAX package: ``core/`` (limb
arithmetic, secp256k1, Paillier keys), ``ops/`` (modular arithmetic, the
CUDA mulmod kernel, SHA-256, batched Paillier), ``engine/`` (batched
GG18 signing), ``protocol/`` (share records).

Entry points run on the GPU unless the caller passes ``device="cpu"``;
without a GPU they raise instead of moving work to the CPU.
"""

__version__ = "0.1.0"
