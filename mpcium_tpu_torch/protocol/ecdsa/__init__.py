"""ECDSA protocol pieces of the port: the per-session GG18 keygen and
signing parties with the host MtA and proofs, the OT-MtA backend, and
the batched GG18 signing party."""
