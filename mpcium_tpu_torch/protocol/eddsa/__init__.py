"""EdDSA protocol pieces of the port: the per-session keygen and signing
parties and the batched signing party."""
