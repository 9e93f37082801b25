"""Records of the per-session protocols, in JSON form.

What two implementations of the per-session parties must agree on for
the same seeded streams (one ``SeededStream`` per party):

- EdDSA: a 2-of-3 ``EDDSAKeygenParty`` run, a sign by each quorum of
  ``ED["quorums"]``, a ``ResharingParty`` rotation to a committee that
  overlaps the old one and brings a newcomer, and a sign with the new
  shares;
- ECDSA on the 1024-bit fixture (peers' minimum key size lowered): a
  2-of-3 ``ECDSAKeygenParty`` run and a ``ResharingParty`` rotation in
  which one member deals and leaves, one deals and stays and two only
  receive;
- ECDSA signing on 2048-bit shares dealt from a seeded polynomial with
  the fixture's ``aux`` (a 1024-bit N is too narrow: β′ < q⁵ has 1,280
  bits): an ``ECDSASigningParty`` sign by each quorum of
  ``EC["quorums"]``.

Each run records every wire message in the in-process runner's order
(``wire_record``), every result (``KeygenShare.to_json()`` with its
``epoch`` and ``aux``, or the signature) and the SHA-256 of the
canonical JSON of one party's snapshot, taken after the number of
deliveries ``SNAP`` names. With ``restore=True`` that party is then replaced
by a fresh one, built with the same arguments and random stream and
restored from the snapshot after a trip through JSON: the record must
not change. The functions take the classes under test (the JAX
package's or the port's), so one record format serves the JAX package
on the CPU, the port on the CPU and the port on the card.
"""
from __future__ import annotations

import json
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from .rng import SeededStream
from .wire_record import digest, wire_entry

UNIVERSE = ["node0", "node1", "node2"]
THRESHOLD = 1
ED = {"session": "session-eddsa-golden", "keygen": 900, "sign": 910, "reshare": 930,
      "quorums": [["node0", "node2"], ["node1", "node2"]],
      "old_quorum": ["node0", "node2"], "new_committee": ["node1", "node2", "node3"],
      "t_new": 1, "messages": [b"session eddsa golden", b"", bytes(range(200))]}
# node0 deals and stays, node2 deals and leaves (no result), node1 holds
# an old share but only receives, node3 is new. node3's 1023-bit NTilde
# passes the lowered minimum.
EC = {"session": "session-ecdsa-golden", "keygen": 940, "reshare": 950, "deal": 960,
      "sign": 970, "quorums": [["node0", "node1"], ["node1", "node2"]],
      "old_quorum": ["node0", "node2"], "new_committee": ["node0", "node1", "node3"],
      "t_new": 1, "min_paillier_bits": 1020, "digest": 0x5E55 << 200}
# (party, deliveries) of each run's snapshot: every one is mid-protocol,
# after the party has drawn its secrets and before it finishes
SNAP = {"eddsa_keygen": ("node1", 4), "eddsa_sign": ("node2", 2),
        "eddsa_reshare": ("node2", 4), "ecdsa_keygen": ("node2", 5),
        "ecdsa_reshare": ("node0", 4), "ecdsa_sign": ("node1", 9)}


def run_session(parties: Dict, snap: Optional[Tuple[str, int]] = None,
                remake: Optional[Callable] = None) -> Tuple[List, Optional[str]]:
    """Run ``parties`` to the end in ``protocol/runner.py``'s order,
    recording the wire → (wire, digest of the snapshot). ``snap`` =
    (party, deliveries); ``remake(pid, rng)`` builds the fresh party that
    replaces the snapshotted one (None: the run goes on uninterrupted)."""
    wire: List = []
    queue: deque = deque()

    def sent(msgs):
        for m in msgs:
            wire.append(wire_entry(m))
            queue.append(m)

    for _pid, party in sorted(parties.items()):
        sent(party.start())
    snap_digest, delivered = None, 0
    while queue:
        msg = queue.popleft()
        targets = ([p for pid, p in sorted(parties.items()) if pid != msg.from_id]
                   if msg.is_broadcast else [parties[msg.to]])
        for t in targets:
            sent(t.receive(msg))
        delivered += 1
        if snap is not None and delivered == snap[1]:
            pid = snap[0]
            state = parties[pid].snapshot()
            snap_digest = digest(state)
            if remake is not None:
                fresh = remake(pid, parties[pid].rng)
                fresh.restore(json.loads(json.dumps(state)))
                parties[pid] = fresh
    stalled = [pid for pid, p in sorted(parties.items()) if not p.done]
    if stalled:
        raise RuntimeError(f"protocol stalled; undone parties: {stalled}")
    return wire, snap_digest


def _run(make: Callable, pids: List[str], seed: int, snap_key: str, restore: bool):
    parties = {pid: make(pid, SeededStream(seed + i)) for i, pid in enumerate(pids)}
    wire, snap = run_session(parties, SNAP[snap_key], make if restore else None)
    return parties, {"wire": wire, "snapshot": snap}


def _reshare(resharing_cls, key_type: str, spec: Dict, shares: Dict, seed: int,
             snap_key: str, restore: bool, preparams=None, **kw):
    old_q, new_c = spec["old_quorum"], spec["new_committee"]
    first = shares[old_q[0]]

    def make(pid, rng):
        return resharing_cls(
            f"{spec['session']}-reshare", pid, key_type, old_q, new_c, spec["t_new"],
            old_share=shares[pid] if pid in old_q else None,
            old_public_key=first.public_key, old_vss_commitments=first.vss_commitments,
            preparams=preparams[pid] if preparams is not None and pid in new_c else None,
            rng=rng, **kw)

    parties, rec = _run(make, sorted(set(old_q) | set(new_c)), seed, snap_key, restore)
    rec["shares"] = {pid: None if p.result is None else p.result.to_json()
                     for pid, p in parties.items()}
    rec["new_agg"] = {pid: [c.hex() for c in p.new_agg] for pid, p in parties.items()}
    return {pid: p.result for pid, p in parties.items()}, rec


def eddsa_record(keygen_cls, signing_cls, resharing_cls, restore: bool = False,
                 **sign_kw) -> Dict:
    """Keygen, a sign by each quorum, a reshare, a sign by the new
    committee's last two members. ``sign_kw`` goes to the signing
    parties (the port's ``device``)."""
    sid = ED["session"]
    parties, keygen = _run(lambda pid, rng: keygen_cls(f"{sid}-keygen", pid, UNIVERSE,
                                                       THRESHOLD, rng=rng),
                           UNIVERSE, ED["keygen"], "eddsa_keygen", restore)
    shares = {pid: p.result for pid, p in parties.items()}
    keygen["shares"] = {pid: s.to_json() for pid, s in shares.items()}

    def sign(tag: str, quorum: List[str], held: Dict, msg: bytes, seed: int) -> Dict:
        parties, rec = _run(
            lambda pid, rng: signing_cls(f"{sid}-{tag}", pid, quorum, held[pid], msg,
                                         rng=rng, **sign_kw),
            quorum, seed, "eddsa_sign", restore)
        rec["signatures"] = {pid: p.result.hex() for pid, p in parties.items()}
        return rec

    signs = [sign(f"sign{i}", q, shares, ED["messages"][i], ED["sign"] + 10 * i)
             for i, q in enumerate(ED["quorums"])]
    new, reshare = _reshare(resharing_cls, "ed25519", ED, shares, ED["reshare"],
                            "eddsa_reshare", restore)
    after = sign("sign-after-reshare", ED["new_committee"][1:], new, ED["messages"][2],
                 ED["sign"] + 50)
    return {"keygen": keygen, "sign": signs, "reshare": reshare, "sign_after_reshare": after}


def ecdsa_keygen_record(keygen_cls, resharing_cls, preparams, restore: bool = False) -> Dict:
    """Keygen and reshare on the 1024-bit fixture ``preparams``."""
    sid = EC["session"]
    lowered = EC["min_paillier_bits"]
    parties, keygen = _run(
        lambda pid, rng: keygen_cls(f"{sid}-keygen", pid, UNIVERSE, THRESHOLD, preparams[pid],
                                    rng=rng, min_paillier_bits=lowered),
        UNIVERSE, EC["keygen"], "ecdsa_keygen", restore)
    shares = {pid: p.result for pid, p in parties.items()}
    keygen["shares"] = {pid: s.to_json() for pid, s in shares.items()}
    _new, reshare = _reshare(resharing_cls, "secp256k1", EC, shares, EC["reshare"],
                             "ecdsa_reshare", restore, preparams=preparams,
                             min_paillier_bits=lowered)
    return {"keygen": keygen, "reshare": reshare}


def ecdsa_sign_record(deal, signing_cls, preparams, restore: bool = False) -> Dict:
    """``deal``: the package's ``dealer_keygen_secp_batch``; one wallet
    over the 2048-bit fixture ``preparams``, signed by each quorum."""
    dealt = deal(1, UNIVERSE, THRESHOLD, rng=SeededStream(EC["deal"]), preparams=preparams)
    shares = {pid: row[0] for pid, row in zip(UNIVERSE, dealt)}
    out = []
    for i, quorum in enumerate(EC["quorums"]):
        parties, rec = _run(
            lambda pid, rng: signing_cls(f"{EC['session']}-sign{i}", pid, quorum, shares[pid],
                                         EC["digest"], rng=rng),
            quorum, EC["sign"] + 10 * i, "ecdsa_sign", restore)
        rec["signatures"] = {pid: {k: str(v) for k, v in p.result.items()}
                             for pid, p in parties.items()}
        out.append(rec)
    return {"public_key": shares[UNIVERSE[0]].public_key.hex(), "sign": out}
