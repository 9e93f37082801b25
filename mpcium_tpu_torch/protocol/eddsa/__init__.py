"""EdDSA protocol pieces of the port (the batched signing party)."""
