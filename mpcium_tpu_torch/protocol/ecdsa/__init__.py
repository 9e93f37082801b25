"""ECDSA protocol pieces of the port: the OT-MtA backend, the batched
GG18 signing party and the proofs its keygen material carries."""
