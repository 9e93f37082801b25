"""The port's performance tooling (the JAX package's ``perf/``):

- ``compile_watch``: the ledger of K0's builds and the kernel gauges a
  daemon's health carries;
- ``envfp``: the environment stamp a record carries, and the key the
  ledger groups stamps by;
- ``profile``: ``MPCIUM_PROFILE=1`` captures the card's timeline with
  ``torch.profiler`` and folds its device time into the engines' phases;
- ``statcheck`` + ``microbench``: the micro-benches and their statistical
  regression gate;
- ``ledger`` + ``report``: the committed perf artifacts normalized into
  one history and rendered as a dashboard and a counter track;
- ``claims``: the claims ledger, whose counts a daemon's health carries.

Nothing here imports torch at module scope.
"""
