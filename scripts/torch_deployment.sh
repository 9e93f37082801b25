#!/usr/bin/env bash
# Production launcher of a port node (mpcium-tpu-torch; reference
# deployment_script.sh): pull secrets from the environment / secret manager
# into env-override config keys and exec the daemon. Never write secrets
# into config.yaml on disk.
set -euo pipefail

NODE_NAME="${1:?usage: torch_deployment.sh <node-name>}"

: "${MPCIUM_BADGER_PASSWORD:?export MPCIUM_BADGER_PASSWORD (share-store key)}"
: "${MPCIUM_BROKER_TOKEN:?export MPCIUM_BROKER_TOKEN (broker auth)}"
export MPCIUM_ENVIRONMENT=production

exec mpcium-tpu-torch start -n "$NODE_NAME" --decrypt-private-key
