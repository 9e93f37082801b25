"""The port's serving stores against the JAX package's, live (pure
python): ``store/kvstore.py`` (an ``EncryptedFileKV`` written by one
package opens in the other, both ways), ``store/keyinfo.py`` and
``registry/registry.py`` (equal records, and each package sees the
other's nodes ready on one control KV), and ``store/session_wal.py``:
a party journaled to the WAL the way ``node/session.py`` journals it,
crashed mid-protocol and rebuilt from the replay, ends with the
uninterrupted run's transcript and shares (the WAL written by the port
replays in the JAX package's store too).
"""
from __future__ import annotations

import json
import random
from collections import deque

import pytest

from mpcium_tpu.registry.registry import PeerRegistry as JaxRegistry
from mpcium_tpu.store import keyinfo as jki
from mpcium_tpu.store import kvstore as jkv
from mpcium_tpu.store import session_wal as jwal

from mpcium_tpu_torch import wire
from mpcium_tpu_torch.node.session import _msg_from_json, _msg_to_json
from mpcium_tpu_torch.protocol.base import RoundMsg
from mpcium_tpu_torch.protocol.eddsa.keygen import EDDSAKeygenParty
from mpcium_tpu_torch.registry.registry import PeerRegistry
from mpcium_tpu_torch.store import keyinfo as pki
from mpcium_tpu_torch.store import kvstore as pkv
from mpcium_tpu_torch.store import session_wal as pwal
from mpcium_tpu_torch.utils.rng import SeededStream
from mpcium_tpu_torch.utils.wire_record import wire_entry

PW = "store-pass"


def _values(seed: int):
    r = random.Random(seed)
    return {f"ecdsa:w{i}": bytes(r.getrandbits(8) for _ in range(r.randrange(0, 3000)))
            for i in range(5)}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_encrypted_file_kv_opens_in_the_other_package(tmp_path, writer):
    mk_w, mk_r = (jkv.EncryptedFileKV, pkv.EncryptedFileKV) if writer == "jax" else \
        (pkv.EncryptedFileKV, jkv.EncryptedFileKV)
    vals = _values(3 if writer == "jax" else 4)
    w = mk_w(tmp_path, PW)
    for k, v in vals.items():
        w.put(k, v)
    w.delete("ecdsa:w4")
    r = mk_r(tmp_path, PW)
    assert r.keys() == sorted(k for k in vals if k != "ecdsa:w4") == w.keys()
    assert all(r.get(k) == vals[k] for k in r.keys()) and r.get("ecdsa:w4") is None
    assert r.hashed_name("wal:x") == w.hashed_name("wal:x")
    r.put("eddsa:new", b"\x07" * 70)
    assert mk_w(tmp_path, PW).get("eddsa:new") == b"\x07" * 70
    with pytest.raises(ValueError, match="wrong encryption password"):
        mk_r(tmp_path, "another")


def test_memory_and_file_kv_match_jax(tmp_path):
    for pk, jk in ((pkv.MemoryKV(), jkv.MemoryKV()),
                   (pkv.FileKV(tmp_path / "p"), jkv.FileKV(tmp_path / "j"))):
        for store in (pk, jk):
            store.put("ready/node 1", b"1")
            store.put("threshold_keyinfo/ecdsa:w/x", b"2")
            store.put("a", b"3")
            store.delete("a")
        assert pk.keys() == jk.keys() and pk.keys("ready/") == jk.keys("ready/")
        assert [pk.get(k) for k in pk.keys()] == [jk.get(k) for k in jk.keys()]


@pytest.mark.parametrize("key_type", ["secp256k1", "ed25519"])
def test_keyinfo_records_equal_jax(key_type):
    kw = dict(participant_peer_ids=["node0", "node1", "node2"], threshold=1,
              is_reshared=True, public_key="02" + "ab" * 32,
              vss_commitments=["03" + "cd" * 32, "02" + "ef" * 32], epoch=3)
    pkv_, jkv_ = pkv.MemoryKV(), jkv.MemoryKV()
    pki.KeyinfoStore(pkv_).save(key_type, "w-7", pki.KeyInfo(**kw))
    jki.KeyinfoStore(jkv_).save(key_type, "w-7", jki.KeyInfo(**kw))
    assert pkv_.keys() == jkv_.keys() == [jki.KeyinfoStore._key(key_type, "w-7")]
    assert pkv_.get(pkv_.keys()[0]) == jkv_.get(jkv_.keys()[0])
    back = pki.KeyinfoStore(jkv_).get(key_type, "w-7")
    assert back.to_json() == jki.KeyInfo(**kw).to_json()


def test_registries_see_each_other_on_one_control_kv():
    kv = pkv.MemoryKV()
    ids = ["node0", "node1", "node2"]
    regs = [PeerRegistry("node0", ids, kv, poll_interval_s=0.05),
            JaxRegistry("node1", ids, kv, poll_interval_s=0.05),
            PeerRegistry("node2", ids, kv, poll_interval_s=0.05)]
    try:
        for r in regs:
            r.watch()
            r.ready()
        assert all(r.wait_all_ready(5) for r in regs)
        assert kv.keys("ready/") == [f"ready/{n}" for n in ids]
        assert all(r.ready_peers() == ids for r in regs)
        regs[1].resign()
        regs[0]._poll_once()
        assert regs[0].ready_peers() == ["node0", "node2"] and not regs[0].all_ready()
    finally:
        for r in regs:
            r.resign()


# ---------------------------------------------------------------------------
# the session WAL: journal one party as node/session.py does, crash it,
# rebuild it from the replay and finish the run
# ---------------------------------------------------------------------------

UNIVERSE = ["node0", "node1", "node2"]
SID = "keygen:eddsa:wal-wallet"


def _keygen(pid, rng):
    return EDDSAKeygenParty(SID, pid, UNIVERSE, 1, rng=rng)


def _run(parties, wal_pid=None, writer=None, crash_after=None, store=None):
    """Run ``parties`` in the in-process runner's order, recording the
    wire (each message once). ``wal_pid``'s party journals to ``writer``
    like a Session: a checkpoint before its outputs are routed, each
    inbound envelope before delivery. After ``crash_after`` deliveries
    to it, the party and its writer are dropped and a fresh party is
    rebuilt from ``store``'s replay of the WAL: restored from the last
    checkpoint, its sent history routed again, post-checkpoint envelopes
    redelivered."""
    wire_log, seen, queue, resumed = [], set(), deque(), []

    def route(msgs):
        for m in msgs:
            entry = json.dumps(wire_entry(m), sort_keys=True)
            if entry not in seen:  # a resumed party re-sends its history
                seen.add(entry)
                wire_log.append(entry)
            queue.append(m)

    def journal(pid, out):
        if pid == wal_pid and writer[0] is not None:
            writer[0].checkpoint(parties[pid].snapshot(), [_msg_to_json(m) for m in out])

    for pid, party in sorted(parties.items()):
        out = party.start()
        journal(pid, out)
        route(out)
    delivered = 0
    while queue:
        msg = queue.popleft()
        targets = [p for p in sorted(parties) if p != msg.from_id] if msg.is_broadcast \
            else [msg.to]
        for pid in targets:
            party = parties[pid]
            if pid == wal_pid and writer[0] is not None:
                env = wire.Envelope(msg.session_id, msg.round, msg.from_id, msg.payload,
                                    to=msg.to, is_broadcast=msg.is_broadcast)
                writer[0].envelope(env.encode())
            if party.done:
                continue
            out = party.receive(msg)
            if out or party.done:
                journal(pid, out)
            route(out)
            if pid == wal_pid and writer[0] is not None:
                delivered += 1
                if delivered == crash_after:
                    rng = party.rng
                    writer[0].close()
                    writer[0] = None  # the process died here
                    [rep] = store.incomplete()
                    fresh = _keygen(pid, rng)
                    fresh.restore(rep.snapshot)
                    parties[pid] = fresh
                    writer[0] = store.reopen(rep)
                    resumed.append(len(rep.envelopes))
                    route([_msg_from_json(d) for d in rep.sent])
                    for raw in rep.envelopes:
                        env = wire.Envelope.decode(raw)
                        out = fresh.receive(RoundMsg(env.session_id, env.round, env.from_id,
                                                     env.payload, env.to))
                        if out or fresh.done:
                            journal(pid, out)
                        route(out)
    assert all(p.done for p in parties.values())
    return wire_log, {pid: p.result.to_json() for pid, p in parties.items()}, resumed


@pytest.mark.parametrize("crash_after", [1, 2, 3])
def test_wal_replays_a_crashed_party_to_the_uninterrupted_transcript(tmp_path, crash_after):
    base_wire, base_shares, _ = _run({pid: _keygen(pid, SeededStream(60 + i))
                                   for i, pid in enumerate(UNIVERSE)})
    kv = pkv.EncryptedFileKV(tmp_path, PW)
    store = pwal.SessionWALStore(kv, fsync=False)
    writer = [store.create(SID, {"kind": "keygen", "key_type": "ed25519",
                                 "wallet_id": "wal-wallet", "threshold": 1,
                                 "participants": UNIVERSE})]
    # the WAL, as written at the crash, replays in the JAX package's store too
    got_wire, got_shares, resumed = _run({pid: _keygen(pid, SeededStream(60 + i))
                                 for i, pid in enumerate(UNIVERSE)},
                                "node1", writer, crash_after, store)
    assert len(resumed) == 1, "the party never crashed"
    assert got_wire == base_wire
    assert got_shares == base_shares
    [rep] = store.incomplete()
    jrep = jwal.SessionWALStore(jkv.EncryptedFileKV(tmp_path, PW), fsync=False).replay(rep.path)
    assert (jrep.session_id, jrep.meta, jrep.snapshot, jrep.sent, jrep.records) == \
        (rep.session_id, rep.meta, rep.snapshot, rep.sent, rep.records)
    assert rep.snapshot is not None and not rep.torn
    writer[0].done()
    writer[0].drop()
    assert store.incomplete() == []


def test_wal_torn_tail_is_truncated(tmp_path):
    store = pwal.SessionWALStore(pkv.EncryptedFileKV(tmp_path, PW), fsync=False)
    w = store.create("s-torn", {"kind": "sign"})
    w.envelope(b'{"x":1}')
    w.checkpoint({"k": 1}, [])
    w.close()
    path = store._path("s-torn")
    with open(path, "ab") as f:
        f.write(b"\x00\x00\x01\x00garbage")
    [rep] = store.incomplete()
    assert rep.torn and rep.records == 3 and rep.snapshot == {"k": 1}
    w2 = store.reopen(rep)
    w2.done()
    w2.close()
    assert store.incomplete() == [] and path.stat().st_size > rep.valid_bytes
