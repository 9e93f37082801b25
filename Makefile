# mpcium_tpu developer entry points (reference Makefile: go install ./cmd/...)

PY ?= python

.PHONY: install lint check shapecheck warmcheck claimscheck prewarm trace-check perfcheck perf-tests test test-all bench tpu-round broker chaos soak soak-tests setup-identities setup-initiator clean torch-verify-drive torch-trace-check torch-perfcheck torch-claimscheck torch-prewarm torch-warmcheck

install:
	pip install -e . --no-build-isolation --no-deps

# static analysis (STATIC_ANALYSIS.md): ruff and mypy run when installed
# (the hermetic CI image ships neither — their defect classes are covered
# natively by mpclint MPL6xx); mpclint + mpcflow + mpcshape always run
# and are the gate — check_all parses the AST once and feeds all three.
lint:
	@if $(PY) -c "import ruff" 2>/dev/null || command -v ruff >/dev/null 2>&1; then \
	  echo "== ruff"; ruff check mpcium_tpu/ scripts/ tests/ || exit $$?; \
	else echo "== ruff not installed — skipped (MPL6xx covers its classes)"; fi
	@if $(PY) -c "import mypy" 2>/dev/null; then \
	  echo "== mypy"; $(PY) -m mypy mpcium_tpu/wire.py mpcium_tpu/config.py mpcium_tpu/utils/ || exit $$?; \
	else echo "== mypy not installed — skipped"; fi
	@echo "== mpclint + mpcflow + mpcshape"; $(PY) scripts/check_all.py

# the one-pass static gate alone (mpclint + mpcflow + mpcshape +
# budget/surface drift, shared AST parse) — what CI calls between edit
# and test; the trace gate rides along (--no-sweep: the sweep just
# ran), and perfcheck (statistical micro-bench regression gate, <30 s,
# CPU-safe) closes it
check:
	$(PY) scripts/check_all.py
	$(PY) scripts/trace_check.py --no-sweep
	$(PY) scripts/perfcheck.py

# compile-surface gate alone (STATIC_ANALYSIS.md "Compile surface"):
# MPS9xx rules + COMPILE_SURFACE.json drift. Run
# scripts/mpcshape_surface.py (no --check) after an intentional
# signature change, review the diff, commit the JSON.
shapecheck:
	$(PY) scripts/mpcshape_surface.py --check

# warm-manifest gate alone (PERFORMANCE.md "Warm start"): the pre-warm
# work-list must enumerate exactly surface knobs × engine/buckets with
# no silent gaps — pure stdlib, no jax. Also folded into check_all.
warmcheck:
	$(PY) scripts/prewarm.py --check

# claims drift gate alone (OBSERVABILITY.md "Claims & campaigns"): the
# committed CLAIMS.json/CLAIMS.md must match a fresh evaluation of the
# artifact corpus — 0 unknown metrics, 0 untracked ROADMAP headlines.
# Regenerate after adding an artifact or a claim with
# scripts/claimscheck.py --regen. Also folded into check_all.
claimscheck:
	$(PY) scripts/claimscheck.py

# fill the XLA persistent cache for this host's serving set (the same
# pass the daemon runs at boot with warm_enabled; see scripts/prewarm.py
# for scheme/bucket/budget flags)
prewarm:
	$(PY) scripts/prewarm.py

# statistical perf-regression gate alone (PERFORMANCE.md "perf
# observatory"): micro-benches vs the committed PERF_baseline_micro.json
# under a Mann-Whitney + effect-floor + bootstrap-CI triple gate.
# --update-baseline re-anchors after an intentional perf change;
# --regen-history rebuilds PERF_history.jsonl + PERFORMANCE_dashboard.md
perfcheck:
	$(PY) scripts/perfcheck.py

perf-tests:
	$(PY) -m pytest tests/ -m perf -q

# the PyTorch port's tools (scripts/torch_*.py): on the GPU by default;
# TORCH_DEVICE=cpu runs the plain path (claimscheck and warmcheck read
# files only). On the card: scripts/torch_tools_alone.py through the chip
# tool runs the verify drive, the trace regeneration, the perf gate, the
# prewarm walk and the signing example in turn.
TORCH_DEVICE ?=
TORCH_DEV = $(if $(TORCH_DEVICE),--device $(TORCH_DEVICE))

torch-verify-drive:
	$(PY) scripts/torch_verify_drive.py $(TORCH_DEV)

torch-trace-check:
	$(PY) scripts/torch_trace_check.py $(TORCH_DEV)

# strict only against a baseline taken on this host and device
# (mpcium_tpu_torch/data/perf_baseline_micro_gpu.json); informational elsewhere
torch-perfcheck:
	$(PY) scripts/torch_perfcheck.py $(TORCH_DEV)

torch-claimscheck:
	$(PY) scripts/torch_claimscheck.py

torch-prewarm:
	$(PY) scripts/torch_prewarm.py $(TORCH_DEV)

torch-warmcheck:
	$(PY) scripts/torch_prewarm.py --check

# mpctrace gate alone (OBSERVABILITY.md): committed TRACE_sample.json
# validates + covers every instrumented layer, and a traced protocol
# run is transcript-identical to an untraced one; includes the static
# sweep so it is self-contained. --regen rebuilds the sample.
trace-check:
	$(PY) scripts/trace_check.py

# smoke tier (< ~1 min target on a laptop core; full crypto suites are slow-marked)
test:
	$(PY) -m pytest tests/ -m "not slow" -q

# per-file: XLA's CPU AOT cache deserialization can segfault rarely in
# very long single processes on some hosts; file-scoped runs are isolated
# (and each file's kernels stay warm in the persistent cache)
test-all:
	@set -e; for f in tests/test_*.py; do \
	  echo "== $$f"; \
	  rc=0; $(PY) -m pytest "$$f" -q --no-header || rc=$$?; \
	  if [ $$rc -ge 128 ]; then \
	    echo "== crash (rc=$$rc); retrying without compile cache (AOT flake isolation): $$f"; \
	    MPCIUM_TESTS_NO_CACHE=1 $(PY) -m pytest "$$f" -q --no-header; \
	  elif [ $$rc -ne 0 ]; then \
	    echo "== FAILED (rc=$$rc): $$f"; exit $$rc; \
	  fi; \
	done

bench:
	$(PY) bench.py

# the ROADMAP item-1 round as one resumable command (claims ledger +
# campaign runner). In a live TPU window: `make tpu-round`; anywhere:
# `python scripts/tpu_round.py --rehearse` proves the harness on CPU.
tpu-round:
	$(PY) scripts/tpu_round.py

# chaos drills (ISSUE 3): the full catalog, JSON reports, non-zero exit
# on any missed expected outcome; reproduce a failure with --seed
chaos:
	$(PY) scripts/chaos_drill.py --seed 7

chaos-tests:
	$(PY) -m pytest tests/ -m chaos -q

# SLO load soak (ISSUE 6): bursty mixed traffic + batch-chaos fault plan,
# accounting invariant enforced (non-zero exit on any silent drop);
# committed reports (SOAK_*.json) come from this entry point
soak:
	$(PY) scripts/load_soak.py --out SOAK_local.json

soak-tests:
	$(PY) -m pytest tests/ -m soak -q

# dev stack: durable broker on :4333 (the docker-compose/nats analogue)
broker:
	$(PY) -m mpcium_tpu.cli.main broker --port 4333 --journal ./broker-queue.jsonl

setup-identities:
	bash scripts/setup_identities.sh

setup-initiator:
	bash scripts/setup_initiator.sh

clean:
	rm -rf db control broker-queue.jsonl identity peers.json
