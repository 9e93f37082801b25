#!/usr/bin/env bash
# Bootstrap the event-initiator identity with mpcium-tpu-torch-cli and patch
# its pubkey into config.yaml (reference setup_initiator.sh).
set -euo pipefail
cd "$(dirname "$0")/.."

# unquoted on purpose: with ENCRYPT unset no argument is passed
mpcium-tpu-torch-cli generate-initiator ${ENCRYPT:+--encrypt}

PUB=$(python - <<'EOF'
import json
print(json.load(open("event_initiator.json"))["public_key"])
EOF
)
touch config.yaml
if grep -q '^event_initiator_pubkey:' config.yaml; then
  sed -i "s/^event_initiator_pubkey:.*/event_initiator_pubkey: \"$PUB\"/" config.yaml
else
  echo "event_initiator_pubkey: \"$PUB\"" >> config.yaml
fi
echo "initiator registered in config.yaml: $PUB"
