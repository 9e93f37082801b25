"""The port's performance tooling: ``compile_watch``, the ledger of K0's
builds and the kernel gauges a daemon's health carries, and ``envfp``,
the environment stamp a soak report carries."""
