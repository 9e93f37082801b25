#!/usr/bin/env bash
# Bootstrap a 3-node port dev cluster's identities with mpcium-tpu-torch-cli
# (reference setup_identities.sh): peers.json, per-node Ed25519 identities,
# registration into the control KV.
set -euo pipefail
cd "$(dirname "$0")/.."

N="${1:-3}"

mpcium-tpu-torch-cli generate-peers -n "$N"
mpcium-tpu-torch-cli register-peers

# unquoted on purpose: with ENCRYPT unset no argument is passed (quoted,
# the CLI would get an empty one and refuse it)
for i in $(seq 0 $((N - 1))); do
  mpcium-tpu-torch-cli generate-identity --node "node$i" ${ENCRYPT:+--encrypt}
done

echo "identities ready: $(ls identity/)"
echo "next: scripts/torch_setup_initiator.sh, then 'make broker' and per-node"
echo "      'mpcium-tpu-torch start -n node<i>' (one process per trust domain)"
