"""Threshold Ed25519 signing, one message per session (the port's copy
of ``mpcium_tpu/protocol/eddsa/signing.py``).

A three-round commit–reveal threshold Schnorr:

  R1 (broadcast)  hash commitment to the nonce share point R_i = r_i·B
  R2 (broadcast)  decommitment: R_i
  R3 (broadcast)  partial signature s_i = r_i + H(R‖A‖M)·λ_i·x_i mod l
  finalize        s = Σ s_i; (R, s) must verify under RFC 8032

Each R_i is fixed before any is revealed, which keeps concurrent signing
safe from nonce-bias (ROS) attacks. The result is a standard RFC 8032
signature over the wallet key A. Nonces are random: no party holds the
whole key, so RFC 8032's deterministic nonce cannot apply.

The protocol runs on host python ints. The one device hook is the
challenge: with ``MPCIUM_EDDSA_DEVICE_HASH_SESSION=1`` (read per call)
H(R‖A‖M) goes through the batched SHA-512 on the party's ``device``
(``None``: the GPU, raising when there is none), byte for byte the
hashlib digest of the default path, which never touches a device.
"""
from __future__ import annotations

import os
import secrets
from typing import List, Sequence

from ...core import hostmath as hm
from ...device import DeviceLike
from ...ops.hash_suite import sha512_bytes
from .. import commitments as cm
from ..base import KeygenShare, PartyBase, ProtocolError, RoundMsg, party_xs

R1 = "eddsa/sign/1"
R2 = "eddsa/sign/2"
R3 = "eddsa/sign/3"

ENV_DEVICE_HASH = "MPCIUM_EDDSA_DEVICE_HASH_SESSION"


def _challenge_int(R_bytes: bytes, A_bytes: bytes, message: bytes,
                   device: DeviceLike = None) -> int:
    """RFC 8032 challenge H(R ‖ A ‖ M) as a little-endian integer: host
    hashlib by default, the device SHA-512 on ``device`` when the switch
    is on (same bytes)."""
    if os.environ.get(ENV_DEVICE_HASH, "0") == "1":
        return int.from_bytes(sha512_bytes(R_bytes + A_bytes + message, device), "little")
    return hm.sha512_int_le(R_bytes, A_bytes, message)


class EDDSASigningParty(PartyBase):
    """One signer of the chosen quorum (≥ t+1 keygen participants, each
    holding its keygen share of the wallet). ``device`` is used only
    when the switch sends the challenge to the device."""

    # a resumed signer MUST reuse the exact r_i it committed to, or its
    # peers see a decommitment mismatch
    _SNAP_EXTRA = (
        "_sent_r2", "_sent_r3", "_r", "_R_i", "_R_i_bytes", "_commitment",
        "_blind", "_R_bytes", "_s_i", "_c",
    )

    def __init__(self, session_id: str, self_id: str, party_ids: Sequence[str],
                 share: KeygenShare, message: bytes, rng=None, device: DeviceLike = None):
        super().__init__(session_id, self_id, party_ids, rng or secrets)
        if len(party_ids) < share.threshold + 1:
            raise ProtocolError("not enough participants for threshold")
        if share.key_type != "ed25519":
            raise ValueError("wrong key type for EdDSA signing")
        self.share = share
        self.message = message
        self.device = device
        # Shamir x-coordinates come from the keygen universe, NOT the
        # quorum: Lagrange interpolation is silently wrong for any quorum
        # that is not a sorted prefix of it
        keygen_xs = party_xs(share.participants)
        for pid in party_ids:
            if pid not in keygen_xs:
                raise ProtocolError("signer not in keygen participant set", pid)
        self.sign_xs = {pid: keygen_xs[pid] for pid in self.party_ids}
        self.xs = self.sign_xs
        self.self_x = self.sign_xs[self_id]
        assert self.self_x == share.self_x
        self._sent_r2 = False
        self._sent_r3 = False

    # -- round 1 ------------------------------------------------------------

    def start(self) -> List[RoundMsg]:
        self._r = self.rng.randbelow(hm.ED_L - 1) + 1
        self._R_i = hm.ed_mul(self._r, hm.ED_B)
        self._R_i_bytes = hm.ed_compress(self._R_i)
        self._commitment, self._blind = cm.commit(self._R_i_bytes, rng=self.rng)
        return [self.broadcast(R1, {"commitment": self._commitment.hex()})]

    # -- message handling ---------------------------------------------------

    def receive(self, msg: RoundMsg) -> List[RoundMsg]:
        if self.done:
            return []
        self._store(msg)
        out: List[RoundMsg] = []
        others = self.others()
        if not self._sent_r2 and self._round_full(R1, others):
            self._sent_r2 = True
            out.append(self.broadcast(R2, {"R": self._R_i_bytes.hex(),
                                           "blind": self._blind.hex()}))
        if self._sent_r2 and not self._sent_r3 and self._round_full(R2, others):
            out.append(self._round3())
        if self._sent_r3 and not self.done and self._round_full(R3, others):
            self._finalize()
        return out

    # -- round 3: partial signature -----------------------------------------

    def _round3(self) -> RoundMsg:
        self._sent_r3 = True
        commits = self._round_payloads(R1)
        decommits = self._round_payloads(R2)
        R_points = {self.self_id: self._R_i}
        for pid in self.others():
            Rb = bytes.fromhex(decommits[pid]["R"])
            if not cm.verify(bytes.fromhex(commits[pid]["commitment"]),
                             bytes.fromhex(decommits[pid]["blind"]), Rb):
                raise ProtocolError("nonce decommitment mismatch", pid)
            try:
                R_points[pid] = hm.ed_decompress(Rb)
            except ValueError as e:
                raise ProtocolError(f"bad nonce point: {e}", pid)

        R = hm.ED_IDENT
        for pid in self.party_ids:
            R = hm.ed_add(R, R_points[pid])
        self._R_bytes = hm.ed_compress(R)

        c = _challenge_int(self._R_bytes, self.share.public_key, self.message,
                           self.device) % hm.ED_L
        lam = hm.lagrange_coeff(list(self.sign_xs.values()), self.self_x, hm.ED_L)
        self._s_i = (self._r + c * lam * self.share.share) % hm.ED_L  # mpcflow: declassified — partial response sᵢ is the R3 broadcast
        self._c = c
        return self.broadcast(R3, {"s": str(self._s_i)})

    # -- finalize -----------------------------------------------------------

    def _finalize(self) -> None:
        partials = self._round_payloads(R3)
        s = 0
        for pid in self.others():
            v = int(partials[pid]["s"])
            if not 0 <= v < hm.ED_L:
                raise ProtocolError("partial signature out of range", pid)
            s = (s + v) % hm.ED_L
        s = (s + self._s_i) % hm.ED_L  # own partial, as broadcast in R3
        sig = self._R_bytes + s.to_bytes(32, "little")
        # verify before publishing
        if not hm.ed25519_verify(self.share.public_key, self.message, sig):
            raise ProtocolError("aggregate signature failed verification")
        self.result = sig
        self.done = True
