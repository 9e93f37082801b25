"""ECDSA protocol pieces of the port (the OT-MtA backend)."""
