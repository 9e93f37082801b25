"""Fixture loading for the port (the serving cluster comes in a later
slice). The two committed pre-parameter fixtures are the port's own
copies of the JAX package's ``data/test_preparams*.json``."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

from .core.paillier import PreParams

DATA = Path(__file__).resolve().parent / "data"


def load_test_preparams(bits: int = 2048) -> Dict[str, PreParams]:
    """The committed fixtures (TEST/BENCH ONLY). ``bits=2048`` is the
    full-size key set, ``bits=1024`` the shrunk one of the fast tests."""
    name = "test_preparams.json" if bits == 2048 else f"test_preparams_{bits}.json"
    with open(DATA / name) as f:
        d = json.load(f)["preparams"]
    return {k: PreParams.from_json(v) for k, v in d.items()}
