"""PyTorch / CUDA port of mpcium_tpu for NVIDIA Hopper GPUs.

A package of its own beside ``mpcium_tpu`` (the JAX reference, which it
never imports). Layout mirrors the JAX package: ``core/`` (limb
arithmetic, the secp256k1 and ed25519 groups, Paillier keys and prime
generation), ``ops/`` (modular arithmetic, the CUDA mulmod kernel,
SHA-256 and SHA-512, batched Paillier), ``engine/`` (the batched GG18,
EdDSA and DKG engines), ``protocol/`` (share records, the batched and
per-session parties, the snapshot codec).

Entry points run on the GPU unless the caller passes ``device="cpu"``;
without a GPU they raise instead of moving work to the CPU.
"""

__version__ = "0.1.0"
