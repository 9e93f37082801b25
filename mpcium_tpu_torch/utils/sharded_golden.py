"""Records of the sharded signing step, in JSON form.

What two implementations of ``engine/sharded`` must agree on for the
same seeded inputs: the EdDSA two-phase step's signatures and ok masks
(``sharded_sign``) and the GG18 curve leg of the multi-device dry run
(``gg18_curve_leg``: r, s and the ok mask). The inputs are host arrays
made here from seeds — dealer wallets from a :class:`SeededStream`,
nonces, messages and digests from numpy — so the JAX package's mesh of
eight virtual CPU devices, the port's CPU meshes and the port on the
card all sign the same bytes.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..core import hostmath as hm
from .ot_golden import host
from .rng import SeededStream

UNIVERSE = ["node0", "node1", "node2"]
QUORUM = ["node0", "node1"]
THRESHOLD = 1
B = 8
COMMITTEES = [1, 2]
EDDSA = {"keygen": 701, "nonces": 702, "messages": 703}
GG18 = {"keygen": 711, "signer": 712, "digests": 713}


def eddsa_inputs(B: int = B) -> Dict:
    """r64 (q, B, 64), λ·x limbs (q, B, 22), A (B, 32), the messages
    and the public keys of B dealer ed25519 wallets (2-of-3)."""
    from ..core import bignum as bn
    from ..core.bignum import P256
    from ..engine.eddsa_batch import dealer_keygen_batch
    from ..protocol.base import party_xs

    shares = dealer_keygen_batch(B, UNIVERSE, THRESHOLD, rng=SeededStream(EDDSA["keygen"]))
    xs = party_xs(UNIVERSE)
    quorum_xs = [xs[p] for p in QUORUM]
    lamx = np.stack([
        bn.batch_to_limbs([hm.lagrange_coeff(quorum_xs, xs[pid], hm.ED_L) * s.share % hm.ED_L
                           for s in shares[UNIVERSE.index(pid)]], P256)
        for pid in QUORUM])
    rng = np.random.default_rng(EDDSA["nonces"])
    mrng = np.random.default_rng(EDDSA["messages"])
    return {
        "r64": rng.integers(0, 256, (len(QUORUM), B, 64), dtype=np.uint8),
        "lamx": lamx,
        "A_comp": np.stack([np.frombuffer(s.public_key, np.uint8) for s in shares[0]]),
        "messages": [r.tobytes() for r in mrng.integers(0, 256, (B, 32), dtype=np.uint8)],
        "public_keys": [s.public_key for s in shares[0]],
    }


def eddsa_record(sigs, ok) -> Dict:
    return {"signatures": [bytes(r).hex() for r in host(sigs)],
            "ok": [bool(v) for v in host(ok)]}


def gg18_wallets(gb, B: int = B):
    """B dealer secp256k1 wallets (2-of-3) from ``gb`` (either package's
    ``engine/gg18_batch``) and the (B, 32) digests to sign."""
    shares = gb.dealer_keygen_secp_batch(B, UNIVERSE, THRESHOLD, rng=SeededStream(GG18["keygen"]))
    digests = np.random.default_rng(GG18["digests"]).integers(0, 256, (B, 32), dtype=np.uint8)
    return shares, digests


def gg18_signer_rng() -> SeededStream:
    """The signer's stream: k, γ and the blinds are drawn from it."""
    return SeededStream(GG18["signer"])


def gg18_record(leg: Dict) -> Dict:
    return {"r": [bytes(x).hex() for x in host(leg["r"])],
            "s": [bytes(x).hex() for x in host(leg["s"])],
            "ok": [bool(v) for v in host(leg["ok"])]}


def ecdsa_verified(shares, digests, leg: Dict) -> List[bool]:
    """Each (r, s) of a curve leg checked against its wallet's key on the
    host (python-int ECDSA)."""
    return [hm.ecdsa_verify(hm.secp_decompress(s.public_key),
                            int.from_bytes(bytes(d), "big"),
                            int.from_bytes(bytes(r), "big"), int.from_bytes(bytes(x), "big"))
            for s, d, r, x in zip(shares[0], digests, host(leg["r"]), host(leg["s"]))]
