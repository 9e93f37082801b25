"""Shared bootstrap of the port's examples: an in-process dev cluster on
``--device`` by default, or a running networked deployment with
``--config path/to/config.yaml``.

The port of ``examples/_connect.py``. The in-process cluster is batched
and takes its settings from ``chip_smoke.SERVING_CFG``: a batch on the
GPU runs for minutes (the first GG18 batch pays the comb tables), so the
signing bridge, the deputy's manifest timeout and each request's
deadline outlast one. ``--device`` defaults to the GPU (the cluster
raises without one); ``--device cpu`` runs the plain path. A networked
deployment computes nothing in this process and takes no device.
"""
from __future__ import annotations

import sys
from pathlib import Path
from typing import List, Optional, Tuple

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def _pop(args: List[str], flag: str) -> Optional[str]:
    if flag not in args:
        return None
    i = args.index(flag)
    try:
        value = args[i + 1]
    except IndexError:
        print(f"{flag} requires a value", file=sys.stderr)
        raise SystemExit(2)
    del args[i : i + 2]
    return value


def connect(argv: List[str]) -> Tuple[object, List[str]]:
    """Returns (cluster, leftover_args). The cluster exposes
    create_wallet_sync / sign_sync / reshare_sync / close in either mode
    (``mpcium_tpu_torch.cluster.SyncOps``)."""
    args = list(argv)
    cfg = _pop(args, "--config")
    device = _pop(args, "--device")
    if cfg is not None:
        from mpcium_tpu_torch.cluster import RemoteCluster

        return RemoteCluster(cfg), args
    from chip_smoke import SERVING_CFG
    from mpcium_tpu_torch.cluster import LocalCluster, load_test_preparams

    return (
        LocalCluster(n_nodes=3, threshold=1, preparams=load_test_preparams(),
                     batch_signing=True, device=device, **SERVING_CFG),
        args,
    )
