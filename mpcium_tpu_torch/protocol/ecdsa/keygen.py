"""GG18 ECDSA keygen constants (the per-session keygen party comes in a
later slice of the port)."""

# minimum Paillier modulus size accepted from peers (tss-lib enforces 2048)
MIN_PAILLIER_BITS = 2046
