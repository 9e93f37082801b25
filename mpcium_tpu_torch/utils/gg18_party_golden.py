"""Records of the batched GG18 ECDSA signing party, in JSON form.

What two implementations of ``BatchedECDSASigningParty`` must agree on
for the same shares, digests and seeded streams: every wire message of
a B-wallet batch signed by the QUORUM parties of a 2-of-3 universe (in
the in-process runner's order), each party's result (r, s, recovery,
ok) and each party's quorum material digest. The wire is recorded by
``wire_record`` (a payload field longer than ``INLINE`` characters, such as
a 1024-bit range proof, by its SHA-256). The functions
take the engine module and the party class under test (the JAX
package's or the port's), so one record format serves the JAX package
on the CPU, the port on the CPU and the port on the card.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from .ot_golden import host
from .rng import SeededStream
from .wire_record import run_recorded

UNIVERSE = ["node0", "node1", "node2"]
QUORUM = ["node0", "node1"]
THRESHOLD = 1
# B = 4 so that cohorts = 2 really splits the finalize (two lanes per
# cohort); at B = 2 the pipeline falls back to one cohort
B = 4
DOMAINS = {"alpha": 600, "beta_prime": 320, "gamma_bob": 600}
SEEDS = {"keygen": 701, "digests": 703, "party": 710}
SESSION = "gg18-party-golden-b4"
COHORTS = [1, 2]


def digests(n: int, seed: int) -> List[bytes]:
    rows = np.random.default_rng(seed).integers(0, 256, (n, 32), dtype=np.uint8)
    return [r.tobytes() for r in rows]


def signature_rows(result) -> Dict:
    return {
        "r": [bytes(x).hex() for x in host(result["r"])],
        "s": [bytes(x).hex() for x in host(result["s"])],
        "recovery": [int(v) for v in host(result["recovery"])],
        "ok": [bool(v) for v in host(result["ok"])],
    }


def party_record(gb, party_cls, run_protocol, material_digest, preparams, cohorts: int,
                 **party_kw) -> Dict:
    """Dealer keys with the fixture's aux material, then one batched sign
    by the QUORUM parties, each with its own seeded stream."""
    shares = gb.dealer_keygen_secp_batch(B, UNIVERSE, THRESHOLD,
                                         rng=SeededStream(SEEDS["keygen"]),
                                         preparams=preparams)
    digs = digests(B, SEEDS["digests"])
    parties = {pid: party_cls(SESSION, pid, QUORUM, shares[UNIVERSE.index(pid)], digs,
                              dom=gb.Domains(**DOMAINS), rng=SeededStream(SEEDS["party"] + i),
                              cohorts=cohorts, **party_kw)
               for i, pid in enumerate(QUORUM)}
    wire = run_recorded(parties, run_protocol)
    return {
        "public_keys": [s.public_key.hex() for s in shares[0]],
        "digests": [d.hex() for d in digs],
        "material_digest": {pid: material_digest(shares[UNIVERSE.index(pid)][0])
                            for pid in QUORUM},
        "wire": wire,
        "results": {pid: signature_rows(p.result) for pid, p in parties.items()},
    }
