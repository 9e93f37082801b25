"""Wire messages in JSON form, for the protocol goldens.

A record holds every message a set of parties sends, in the in-process
runner's order, as ``[round, sender, recipient, payload]``. A text or
boolean field of at most INLINE characters is kept in full; a longer or
structured one (a range proof, a DLN proof, a block of points) is kept
as the SHA-256 of its canonical JSON. The parties may be the JAX
package's or the port's: the record is the same for the same bytes.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List

from ..wire import canonical_json

INLINE = 256


def digest(obj) -> str:
    return "sha256:" + hashlib.sha256(canonical_json(obj)).hexdigest()


def wire_entry(m) -> List:
    return [m.round, m.from_id, m.to, {
        k: v if isinstance(v, (str, bool)) and len(str(v)) <= INLINE else digest(v)
        for k, v in m.payload.items()}]


def run_recorded(parties: Dict, run_protocol) -> List:
    """Run ``parties`` to the end, recording each message that a party's
    ``start`` or ``receive`` returns."""
    wire: List = []

    def recorded(fn):
        def call(*args):
            out = fn(*args)
            wire.extend(wire_entry(m) for m in out)
            return out

        return call

    for p in parties.values():
        p.start, p.receive = recorded(p.start), recorded(p.receive)
    run_protocol(parties)
    return wire
