"""MPC node core: session factories + share persistence.

The reference's `mpc.Node` (pkg/mpc/node.go): holds identity/transport/
stores, generates ECDSA pre-params once at startup (node.go:69 — here
loadable from a safe-prime pool file so restarts are instant), and exposes
six factories (ECDSA/EdDSA × keygen/signing/resharing). Share persistence
uses ``ecdsa:<walletID>`` / ``eddsa:<walletID>`` store keys
(session.go:40-43); wallet metadata goes to the keyinfo store.

The port's copy of the JAX package's ``node/node.py``. ``device`` is the
node's card (``None``: the GPU, raising when there is none); the
per-session parties are host python, and only the EdDSA signer may
touch the device, under ``MPCIUM_EDDSA_DEVICE_HASH_SESSION=1``.
"""
from __future__ import annotations

import json
from typing import Callable, Optional, Sequence

from .. import wire
from ..core.paillier import PreParams, gen_preparams
from ..device import DeviceLike, resolve
from ..identity.identity import IdentityStore
from ..protocol.base import KeygenShare, ProtocolError
from ..protocol.ecdsa.keygen import ECDSAKeygenParty
from ..protocol.ecdsa.signing import ECDSASigningParty
from ..protocol.eddsa.keygen import EDDSAKeygenParty
from ..protocol.eddsa.signing import EDDSASigningParty
from ..protocol.resharing import ResharingParty
from ..registry.registry import PeerRegistry
from ..store.keyinfo import KeyInfo, KeyinfoStore
from ..store.kvstore import KVStore
from ..store.session_wal import SessionWALStore, SessionWALWriter, WALReplay
from ..transport.api import Transport
from ..utils import log
from .session import Session

ERR_NOT_ENOUGH_PARTICIPANTS = "not enough participants"


class NotEnoughParticipants(Exception):
    """Signing with a partial cluster — retryable (reference
    ErrNotEnoughParticipants, session.go:22, event_consumer.go:276-280)."""


def share_key(key_type: str, wallet_id: str) -> str:
    kt = {"secp256k1": "ecdsa", "ed25519": "eddsa"}.get(key_type, key_type)
    return f"{kt}:{wallet_id}"


class Node:
    def __init__(
        self,
        node_id: str,
        peer_ids: Sequence[str],
        transport: Transport,
        identity: IdentityStore,
        kvstore: KVStore,
        keyinfo: KeyinfoStore,
        registry: PeerRegistry,
        preparams: Optional[PreParams] = None,
        safe_prime_pool: Optional[str] = None,
        min_paillier_bits: int = 2046,
        hello_timeout_s: Optional[float] = 20.0,
        session_wal: Optional[SessionWALStore] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve(device)
        self.node_id = node_id
        self.peer_ids = sorted(set(peer_ids) | {node_id})
        self.transport = transport
        self.identity = identity
        self.kvstore = kvstore
        self.keyinfo = keyinfo
        self.registry = registry
        self.min_paillier_bits = min_paillier_bits
        # hello-barrier deadline for every session this node creates;
        # chaos drills shrink it so partition failures surface inside the
        # drill budget instead of the default 20 s (session.py:63)
        self.hello_timeout_s = hello_timeout_s
        # crash-recovery WAL namespace (None ⇒ feature off: sessions run
        # exactly as before, no journal files are ever created)
        self.session_wal = session_wal
        # ECDSA pre-params once at startup (reference node.go:69); the pool
        # file makes this seconds instead of minutes
        if preparams is None:
            log.info("generating ECDSA pre-params", node=node_id)
            preparams = gen_preparams(pool_path=safe_prime_pool)
            log.info("pre-params ready", node=node_id)
        self.preparams = preparams
        self.registry.watch()

    # -- persistence --------------------------------------------------------

    def save_share(self, share: KeygenShare, wallet_id: str) -> None:
        self.kvstore.put(
            share_key(share.key_type, wallet_id),
            json.dumps(share.to_json()).encode(),
        )
        self.keyinfo.save(
            share.key_type,
            wallet_id,
            KeyInfo(
                participant_peer_ids=share.participants,
                threshold=share.threshold,
                is_reshared=bool(share.aux.get("is_reshared", False)),
                public_key=share.public_key.hex(),
                vss_commitments=[c.hex() for c in share.vss_commitments],
                epoch=share.epoch,
            ),
        )

    def load_share(self, key_type: str, wallet_id: str) -> KeygenShare:
        raw = self.kvstore.get(share_key(key_type, wallet_id))
        if raw is None:
            raise ProtocolError(f"no {key_type} share for wallet {wallet_id!r}")
        return KeygenShare.from_json(json.loads(raw))

    # -- crash-recovery WAL -------------------------------------------------

    def _wal_create(self, session_id: str, meta: dict) -> Optional[SessionWALWriter]:
        """New journal for a fresh session (``meta`` holds everything
        ``resume_session`` needs to rebuild the party after a crash).
        WAL trouble never blocks live signing — it only disables recovery."""
        if self.session_wal is None:
            return None
        try:
            return self.session_wal.create(session_id, meta)
        except Exception as e:  # noqa: BLE001
            log.warn("session WAL create failed", session=session_id,
                     error=repr(e))
            return None

    # -- quorum selection ---------------------------------------------------

    def _ready_quorum(self, participants: Sequence[str], need: int) -> list:
        ready = set(self.registry.ready_peers())
        quorum = sorted(set(participants) & ready)
        if len(quorum) < need:
            raise NotEnoughParticipants(
                f"{len(quorum)}/{need} ready among {sorted(participants)}"
            )
        return quorum

    # -- keygen -------------------------------------------------------------

    def create_keygen_session(
        self,
        key_type: str,
        wallet_id: str,
        threshold: int,
        on_done: Optional[Callable] = None,
        on_error: Optional[Callable] = None,
    ) -> Session:
        # keygen requires the full configured cluster (reference node.go:95)
        if self.registry.ready_count() < len(self.peer_ids):
            raise NotEnoughParticipants(
                f"{self.registry.ready_count()}/{len(self.peer_ids)} ready"
            )
        participants = list(self.peer_ids)
        session_id = f"keygen:{wire._kt(key_type)}:{wallet_id}"
        if key_type == wire.KEY_TYPE_SECP256K1:
            party = ECDSAKeygenParty(
                session_id, self.node_id, participants, threshold,
                preparams=self.preparams,
                min_paillier_bits=self.min_paillier_bits,
            )
        else:
            party = EDDSAKeygenParty(
                session_id, self.node_id, participants, threshold
            )

        def persist_and_done(share: KeygenShare):
            self.save_share(share, wallet_id)
            if on_done:
                on_done(share)

        return Session(
            session_id=session_id,
            party=party,
            node_id=self.node_id,
            participants=participants,
            transport=self.transport,
            identity=self.identity,
            broadcast_topic=wire.keygen_broadcast_topic(key_type, wallet_id),
            direct_topic_fn=lambda n: wire.keygen_direct_topic(key_type, n, wallet_id),
            on_done=persist_and_done,
            on_error=on_error,
            hello_timeout_s=self.hello_timeout_s,
            wal=self._wal_create(session_id, {
                "kind": "keygen",
                "key_type": key_type,
                "wallet_id": wallet_id,
                "threshold": threshold,
                "participants": participants,
            }),
        )

    # -- signing ------------------------------------------------------------

    def create_signing_session(
        self,
        key_type: str,
        wallet_id: str,
        tx_id: str,
        tx: bytes,
        on_done: Optional[Callable] = None,
        on_error: Optional[Callable] = None,
        network_internal_code: str = "",
    ) -> Optional[Session]:
        """Returns None when this node is not in the selected quorum."""
        info = self.keyinfo.get(key_type, wallet_id)
        if info is None:
            # unknown OR keygen still persisting on this node — retryable;
            # truly unknown wallets exhaust redelivery and surface as a
            # dead-letter timeout (reference redelivery philosophy,
            # event_consumer.go:276-280)
            raise NotEnoughParticipants(
                f"no {key_type} metadata for wallet {wallet_id!r} (yet)"
            )
        quorum = self._ready_quorum(info.participant_peer_ids, info.threshold + 1)
        if self.node_id not in quorum:
            return None
        try:
            share = self.load_share(key_type, wallet_id)
        except ProtocolError:
            raise NotEnoughParticipants(
                f"no {key_type} share for wallet {wallet_id!r} (yet)"
            )
        # reshare-epoch fence: a signing request racing a committee rotation
        # must not build a quorum mixing old- and new-polynomial shares
        # (reference gates on IsReshared, node.go:149-159). A keyinfo/share
        # epoch mismatch means this node is mid-rotation — retryable. The
        # epoch is also baked into the session id and topics below, so nodes
        # on different epochs can never exchange rounds even transiently.
        if share.epoch != info.epoch:
            # interpolate the epoch numbers only, never the share object
            # (its repr would ride the traceback into logs) — MPL102
            epoch_have = share.epoch
            raise NotEnoughParticipants(
                f"reshare in progress for {wallet_id!r}: share epoch "
                f"{epoch_have} != keyinfo epoch {info.epoch}"
            )
        epoch_tag = f"{tx_id}~e{share.epoch}" if share.epoch else tx_id
        session_id = f"sign:{wire._kt(key_type)}:{wallet_id}:{epoch_tag}"
        if key_type == wire.KEY_TYPE_SECP256K1:
            digest = int.from_bytes(tx, "big")
            party = ECDSASigningParty(
                session_id, self.node_id, quorum, share, digest
            )
        else:
            party = EDDSASigningParty(
                session_id, self.node_id, quorum, share, tx, device=self.device
            )
        return Session(
            session_id=session_id,
            party=party,
            node_id=self.node_id,
            participants=quorum,
            transport=self.transport,
            identity=self.identity,
            broadcast_topic=wire.sign_broadcast_topic(
                key_type, wallet_id, epoch_tag
            ),
            direct_topic_fn=lambda n: wire.sign_direct_topic(
                key_type, n, epoch_tag
            ),
            on_done=on_done,
            on_error=on_error,
            hello_timeout_s=self.hello_timeout_s,
            wal=self._wal_create(session_id, {
                "kind": "sign",
                "key_type": key_type,
                "wallet_id": wallet_id,
                "tx_id": tx_id,
                "tx": tx.hex(),
                "epoch_tag": epoch_tag,
                "participants": quorum,
                "network_internal_code": network_internal_code,
            }),
        )

    # -- resharing ----------------------------------------------------------

    def create_resharing_session(
        self,
        key_type: str,
        wallet_id: str,
        new_threshold: int,
        on_done: Optional[Callable] = None,
        on_error: Optional[Callable] = None,
    ) -> Session:
        """Every ready node participates: old-quorum members re-deal, the
        new committee (= all ready nodes) receives. One party object plays
        both roles where they overlap (reference runs two sessions,
        §3.4 — the single dual-role party is the cleaner equivalent)."""
        info = self.keyinfo.get(key_type, wallet_id)
        if info is None:
            raise ProtocolError(f"unknown wallet {wallet_id!r} ({key_type})")
        old_quorum = self._ready_quorum(
            info.participant_peer_ids, info.threshold + 1
        )[: info.threshold + 1]
        new_committee = self.registry.ready_peers()
        if len(new_committee) < new_threshold + 1:
            raise NotEnoughParticipants(
                f"{len(new_committee)} ready < new threshold {new_threshold}+1"
            )
        is_old = self.node_id in old_quorum
        old_share = (
            self.load_share(key_type, wallet_id) if is_old else None
        )
        if old_share is not None and old_share.epoch != info.epoch:
            epoch_have = old_share.epoch
            raise NotEnoughParticipants(
                f"reshare in progress for {wallet_id!r}: share epoch "
                f"{epoch_have} != keyinfo epoch {info.epoch}"
            )
        session_id = f"resharing:{wire._kt(key_type)}:{wallet_id}:e{info.epoch}"
        party = ResharingParty(
            session_id,
            self.node_id,
            key_type,
            old_quorum,
            new_committee,
            new_threshold,
            old_share=old_share,
            old_public_key=bytes.fromhex(info.public_key) if info.public_key else None,
            old_vss_commitments=[bytes.fromhex(c) for c in info.vss_commitments]
            or None,
            preparams=self.preparams if key_type == wire.KEY_TYPE_SECP256K1 else None,
            min_paillier_bits=self.min_paillier_bits,
            old_epoch=info.epoch,
        )

        return Session(
            session_id=session_id,
            party=party,
            node_id=self.node_id,
            participants=sorted(set(old_quorum) | set(new_committee)),
            transport=self.transport,
            identity=self.identity,
            broadcast_topic=wire.resharing_broadcast_topic(key_type, wallet_id),
            direct_topic_fn=lambda n: wire.resharing_direct_topic(key_type, n, wallet_id),
            on_done=self._reshare_persist_cb(
                party, key_type, wallet_id, info, on_done
            ),
            on_error=on_error,
            hello_timeout_s=self.hello_timeout_s,
            wal=self._wal_create(session_id, {
                "kind": "reshare",
                "key_type": key_type,
                "wallet_id": wallet_id,
                "new_threshold": new_threshold,
                "old_quorum": old_quorum,
                "new_committee": new_committee,
                "old_epoch": info.epoch,
            }),
        )

    def _reshare_persist_cb(self, party, key_type, wallet_id, info, on_done):
        """Resharing completion: persist/supersede shares, then chain to the
        caller's callback. Shared by the factory and the crash-resume path."""

        def persist_and_done(share):
            if share is not None:  # new-committee member
                self.save_share(share, wallet_id)
            elif party.is_old:
                # old-only member (excluded from the new committee): its
                # share is superseded — delete it and move keyinfo to the
                # new topology so later signing attempts here neither use a
                # stale polynomial nor list this node as a participant
                # (reference IsReshared gating, node.go:149-159)
                self.kvstore.delete(share_key(key_type, wallet_id))
                self.keyinfo.save(
                    key_type,
                    wallet_id,
                    KeyInfo(
                        participant_peer_ids=list(party.new_committee),
                        threshold=party.new_threshold,
                        is_reshared=True,
                        public_key=info.public_key,
                        vss_commitments=[c.hex() for c in party.new_agg or []],
                        epoch=party.new_epoch,
                    ),
                )
            if on_done:
                on_done(share)

        return persist_and_done

    # -- crash resume -------------------------------------------------------

    def resume_session(
        self,
        rep: WALReplay,
        on_done: Optional[Callable] = None,
        on_error: Optional[Callable] = None,
    ) -> Session:
        """Rebuild an in-flight session from its WAL replay: reconstruct
        the party from the journaled factory arguments, restore the last
        checkpoint, and hand the sent history + post-checkpoint envelopes
        to the Session for wire replay. The participant set comes from the
        journal, NOT from a fresh registry quorum — the peers of the
        original run are the only valid counterparties."""
        if self.session_wal is None:
            raise ProtocolError("session WAL is not enabled")
        meta = rep.meta
        kind = meta.get("kind")
        key_type = meta["key_type"]
        wallet_id = meta["wallet_id"]
        sid = rep.session_id
        if kind == "keygen":
            participants = list(meta["participants"])
            if key_type == wire.KEY_TYPE_SECP256K1:
                party = ECDSAKeygenParty(
                    sid, self.node_id, participants, meta["threshold"],
                    preparams=self.preparams,
                    min_paillier_bits=self.min_paillier_bits,
                )
            else:
                party = EDDSAKeygenParty(
                    sid, self.node_id, participants, meta["threshold"]
                )

            def done_cb(share, _done=on_done):
                self.save_share(share, wallet_id)
                if _done:
                    _done(share)

            broadcast = wire.keygen_broadcast_topic(key_type, wallet_id)
            direct = lambda n: wire.keygen_direct_topic(key_type, n, wallet_id)  # noqa: E731
        elif kind == "sign":
            quorum = list(meta["participants"])
            share = self.load_share(key_type, wallet_id)
            tx = bytes.fromhex(meta["tx"])
            if key_type == wire.KEY_TYPE_SECP256K1:
                party = ECDSASigningParty(
                    sid, self.node_id, quorum, share,
                    int.from_bytes(tx, "big"),
                )
            else:
                party = EDDSASigningParty(sid, self.node_id, quorum, share, tx,
                                          device=self.device)
            epoch_tag = meta["epoch_tag"]
            done_cb = on_done
            broadcast = wire.sign_broadcast_topic(key_type, wallet_id, epoch_tag)
            direct = lambda n: wire.sign_direct_topic(key_type, n, epoch_tag)  # noqa: E731
        elif kind == "reshare":
            info = self.keyinfo.get(key_type, wallet_id)
            if info is None:
                raise ProtocolError(
                    f"cannot resume reshare: no keyinfo for {wallet_id!r}"
                )
            old_quorum = list(meta["old_quorum"])
            new_committee = list(meta["new_committee"])
            is_old = self.node_id in set(old_quorum)
            party = ResharingParty(
                sid,
                self.node_id,
                key_type,
                old_quorum,
                new_committee,
                meta["new_threshold"],
                old_share=self.load_share(key_type, wallet_id) if is_old else None,
                old_public_key=bytes.fromhex(info.public_key)
                if info.public_key else None,
                old_vss_commitments=[bytes.fromhex(c) for c in info.vss_commitments]
                or None,
                preparams=self.preparams
                if key_type == wire.KEY_TYPE_SECP256K1 else None,
                min_paillier_bits=self.min_paillier_bits,
                old_epoch=meta["old_epoch"],
            )
            done_cb = self._reshare_persist_cb(
                party, key_type, wallet_id, info, on_done
            )
            broadcast = wire.resharing_broadcast_topic(key_type, wallet_id)
            direct = lambda n: wire.resharing_direct_topic(key_type, n, wallet_id)  # noqa: E731
        else:
            raise ProtocolError(f"unknown WAL session kind {kind!r}")
        if rep.snapshot is not None:
            party.restore(rep.snapshot)
        # else: no checkpoint survived (crash/torn tail before the first
        # one) — nothing was ever routed, so the party safely starts fresh
        # inside the resume replay (resume_fresh below)
        return Session(
            session_id=sid,
            party=party,
            node_id=self.node_id,
            participants=sorted(party.party_ids),
            transport=self.transport,
            identity=self.identity,
            broadcast_topic=broadcast,
            direct_topic_fn=direct,
            on_done=done_cb,
            on_error=on_error,
            hello_timeout_s=self.hello_timeout_s,
            wal=self.session_wal.reopen(rep),
            resumed=True,
            resume_fresh=rep.snapshot is None,
            resume_sent=rep.sent,
            resume_envelopes=rep.envelopes,
        )
