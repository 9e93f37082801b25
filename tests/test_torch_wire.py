"""The port's wire layer against the JAX package's, live (both are pure
python): ``wire.py`` (envelopes, initiator commands, result events,
topics), ``core/softcrypto.py`` (Ed25519 on the RFC 8032 vectors and on
seeded keys, ChaCha20-Poly1305 with a fixed nonce), envelope and
initiator signatures across ``identity/identity.py`` in both directions,
and the batch scheduler's signed manifest body. Every input comes from a
seed; every comparison is byte for byte.
"""
from __future__ import annotations

import json
import random

import pytest

from mpcium_tpu import wire as jw
from mpcium_tpu.consumers import batch_scheduler as jbs
from mpcium_tpu.core import softcrypto as jsc
from mpcium_tpu.identity import identity as jid

from mpcium_tpu_torch import wire as pw
from mpcium_tpu_torch.consumers import batch_scheduler as pbs
from mpcium_tpu_torch.core import softcrypto as psc
from mpcium_tpu_torch.identity import identity as pid

TRACE = {"t": "00112233aabbccdd", "s": "0000000000000007"}


def _rand(seed: int):
    r = random.Random(seed)
    return r, lambda n: bytes(r.getrandbits(8) for _ in range(n))


def _cases(seed: int):
    """(name, kwargs) for every message and event type, with and without
    the optional fields (v, SLO hints, error shapes)."""
    r, rb = _rand(seed)
    w, tx = f"w-{r.getrandbits(32):08x}", f"tx-{r.getrandbits(32):08x}"
    sig = rb(64)
    return [
        ("GenerateKeyMessage", dict(wallet_id=w, signature=sig)),
        ("GenerateKeyMessage", dict(wallet_id=w, signature=sig, v=1)),
        ("SignTxMessage", dict(key_type="secp256k1", wallet_id=w, network_internal_code="eth",
                               tx_id=tx, tx=rb(32), signature=sig)),
        ("SignTxMessage", dict(key_type="ed25519", wallet_id=w, network_internal_code="sol",
                               tx_id=tx, tx=rb(77), signature=sig, deadline_ms=1500,
                               priority=jw.PRIORITY_INTERACTIVE, v=2)),
        ("ResharingMessage", dict(wallet_id=w, new_threshold=2, key_type="secp256k1",
                                  signature=sig)),
        ("ResharingMessage", dict(wallet_id=w, new_threshold=1, key_type="ed25519",
                                  signature=sig, deadline_ms=9, priority=jw.PRIORITY_INTERACTIVE)),
        ("KeygenSuccessEvent", dict(wallet_id=w, ecdsa_pub_key=rb(33).hex(),
                                    eddsa_pub_key=rb(32).hex())),
        ("KeygenSuccessEvent", dict(wallet_id=w, ecdsa_pub_key="", eddsa_pub_key="",
                                    result_type=jw.RESULT_ERROR, error_reason="shed",
                                    retryable=True, v=1)),
        ("SigningResultEvent", dict(result_type=jw.RESULT_SUCCESS, wallet_id=w, tx_id=tx,
                                    network_internal_code="eth", r=rb(32).hex(), s=rb(32).hex(),
                                    signature_recovery="01")),
        ("SigningResultEvent", dict(result_type=jw.RESULT_ERROR, wallet_id=w, tx_id=tx,
                                    error_reason="deadline", is_timeout=True, retryable=True)),
        ("SigningResultEvent", dict(result_type=jw.RESULT_SUCCESS, wallet_id=w, tx_id=tx,
                                    signature=rb(64).hex(), v=3)),
        ("ResharingSuccessEvent", dict(wallet_id=w, new_threshold=1, key_type="ed25519",
                                       pub_key=rb(32).hex())),
        ("ResharingSuccessEvent", dict(wallet_id=w, new_threshold=2, key_type="secp256k1",
                                       pub_key="", result_type=jw.RESULT_ERROR,
                                       error_reason="epoch fence", retryable=True)),
    ]


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("idx", range(13))
def test_messages_and_events_have_the_jax_bytes_and_round_trip(seed, idx):
    name, kw = _cases(seed)[idx]
    j, p = getattr(jw, name)(**kw), getattr(pw, name)(**kw)
    assert pw.canonical_json(p.to_json()) == jw.canonical_json(j.to_json())
    if hasattr(j, "raw"):
        assert p.raw() == j.raw()
    back = getattr(pw, name).from_json(json.loads(jw.canonical_json(j.to_json())))
    assert pw.canonical_json(back.to_json()) == jw.canonical_json(j.to_json())


@pytest.mark.parametrize("trace", [None, TRACE], ids=["untraced", "traced"])
@pytest.mark.parametrize("broadcast", [True, False])
def test_envelopes_have_the_jax_bytes_and_trace_stays_unsigned(trace, broadcast):
    r, rb = _rand(7)
    kw = dict(session_id="sign:ecdsa:w0:tx0", round="gg18/r2", from_id="node1",
              payload={"b": rb(40).hex(), "n": r.getrandbits(60), "l": [1, "x", None]},
              to=None if broadcast else "node2", is_broadcast=broadcast, signature=rb(64),
              v=0, trace=trace)
    j, p = jw.Envelope(**kw), pw.Envelope(**kw)
    assert p.marshal_for_signing() == j.marshal_for_signing()
    assert p.encode() == j.encode()
    assert pw.Envelope.decode(j.encode()).encode() == j.encode()
    assert jw.Envelope.decode(p.encode()).encode() == p.encode()
    untraced = pw.Envelope(**{**kw, "trace": None})
    assert p.marshal_for_signing() == untraced.marshal_for_signing()
    assert ('"trace"' in p.encode().decode()) == (trace is not None)


def test_topics_constants_and_helpers_are_equal():
    names = [n for n in dir(jw) if n.startswith(("TOPIC_", "KEY_TYPE_", "PRIORITY", "RESULT_"))]
    assert names and all(getattr(pw, n) == getattr(jw, n) for n in names)
    helpers = ["keygen_broadcast_topic", "keygen_direct_topic", "sign_broadcast_topic",
               "sign_direct_topic", "resharing_broadcast_topic", "resharing_direct_topic"]
    for kt in ("secp256k1", "ed25519", "other"):
        for h in helpers:
            args = (kt, "node1", "w-9") if "direct" in h else (kt, "w-9")
            if h.startswith("sign_"):
                args = args + ("tx-3",) if "broadcast" in h else (kt, "node1", "tx-3")
            assert getattr(pw, h)(*args) == getattr(jw, h)(*args), (h, kt)


# RFC 8032 §7.1 tests 1-3: (secret key, public key, message, signature)
RFC8032 = [
    ("9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60",
     "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a", "",
     "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e065224901555fb8821590a33bac"
     "c61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b"),
    ("4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb",
     "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c", "72",
     "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da085ac1e43e15996e"
     "458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00"),
    ("c5aa8df43f9f837bedb7442f31dcb7b166d38535076f094b85ce3a2e0b4458f7",
     "fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025", "af82",
     "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac18ff9b538d16f290"
     "ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a"),
]


@pytest.mark.parametrize("sk,pk,msg,sig", RFC8032)
def test_ed25519_rfc8032_vectors(sk, pk, msg, sig):
    key = psc.Ed25519PrivateKey.from_private_bytes(bytes.fromhex(sk))
    assert key.public_key().public_bytes_raw().hex() == pk
    assert key.sign(bytes.fromhex(msg)).hex() == sig
    psc.Ed25519PublicKey.from_public_bytes(bytes.fromhex(pk)).verify(
        bytes.fromhex(sig), bytes.fromhex(msg))
    bad = bytearray(bytes.fromhex(sig))
    bad[5] ^= 1
    with pytest.raises(psc.InvalidSignature):
        psc.Ed25519PublicKey.from_public_bytes(bytes.fromhex(pk)).verify(
            bytes(bad), bytes.fromhex(msg))


@pytest.mark.parametrize("seed", range(4))
def test_ed25519_on_seeded_keys_equals_jax(seed):
    _r, rb = _rand(100 + seed)
    raw, msg = rb(32), rb(seed * 37)
    jk, pk = jsc.Ed25519PrivateKey(raw), psc.Ed25519PrivateKey(raw)
    assert pk.public_key().public_bytes_raw() == jk.public_key().public_bytes_raw()
    assert pk.sign(msg) == jk.sign(msg)
    jsc.Ed25519PublicKey(pk.public_key().public_bytes_raw()).verify(pk.sign(msg), msg)


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 1000])
def test_chacha20poly1305_fixed_nonce_equals_jax(n):
    _r, rb = _rand(200 + n)
    key, nonce, data, ad = rb(32), rb(12), rb(n), rb(n % 17)
    ct = psc.ChaCha20Poly1305(key).encrypt(nonce, data, ad)
    assert ct == jsc.ChaCha20Poly1305(key).encrypt(nonce, data, ad)
    assert jsc.ChaCha20Poly1305(key).decrypt(nonce, ct, ad) == data
    assert psc.ChaCha20Poly1305(key).decrypt(nonce, ct, ad) == data
    with pytest.raises(psc.InvalidTag):
        psc.ChaCha20Poly1305(key).decrypt(nonce, ct[:-1] + bytes([ct[-1] ^ 1]), ad)


def test_chacha20poly1305_rfc8439_vector():
    key = bytes(range(0x80, 0xA0))
    nonce = bytes.fromhex("070000004041424344454647")
    aad = bytes.fromhex("50515253c0c1c2c3c4c5c6c7")
    text = (b"Ladies and Gentlemen of the class of '99: If I could offer you "
            b"only one tip for the future, sunscreen would be it.")
    ct = psc.ChaCha20Poly1305(key).encrypt(nonce, text, aad)
    assert ct[-16:] == bytes.fromhex("1ae10b594f09e26a7e902ecbd0600691")


@pytest.fixture(scope="module")
def identities(tmp_path_factory):
    """node0 made by the JAX package, node1 by the port, one directory."""
    d = tmp_path_factory.mktemp("ids")
    jid.generate_identity("node0", d)
    pid.generate_identity("node1", d)
    peers = {"node0": "node0", "node1": "node1"}
    init = pid.InitiatorKey.generate()
    return (jid.IdentityStore(d, "node0", peers, initiator_pubkey=init.public_bytes),
            pid.IdentityStore(d, "node1", peers, initiator_pubkey=init.public_bytes), init)


@pytest.mark.parametrize("trace", [None, TRACE], ids=["untraced", "traced"])
def test_signed_envelopes_verify_across_packages(identities, trace):
    jstore, pstore, _ = identities
    pe = pw.Envelope("s1", "r1", "node1", {"x": 1}, trace=trace)
    pstore.sign_envelope(pe)
    je = jw.Envelope.decode(pe.encode())
    assert jstore.verify_envelope(je) and pstore.verify_envelope(pw.Envelope.decode(pe.encode()))
    je2 = jw.Envelope("s1", "r1", "node0", {"y": [2]}, to="node1", is_broadcast=False,
                      trace=trace)
    jstore.sign_envelope(je2)
    assert pstore.verify_envelope(pw.Envelope.decode(je2.encode()))
    forged = pw.Envelope.decode(je2.encode())
    forged.payload = {"y": [3]}
    assert not pstore.verify_envelope(forged)
    assert not pstore.verify_envelope(pw.Envelope("s1", "r1", "node9", {}, signature=b"x" * 64))


def test_initiator_and_peer_signatures_verify_across_packages(identities):
    jstore, pstore, init = identities
    msg = pw.SignTxMessage("ed25519", "w", "sol", "t", b"\x01" * 32)
    msg.signature = init.sign(msg.raw())
    jmsg = jw.SignTxMessage.from_json(json.loads(pw.canonical_json(msg.to_json())))
    assert jstore.verify_initiator(jmsg.raw(), jmsg.signature)
    assert pstore.verify_initiator(msg.raw(), msg.signature)
    assert not pstore.verify_initiator(msg.raw() + b" ", msg.signature)
    body = b"manifest-body"
    assert jstore.verify_peer("node1", body, pstore.sign_raw(body))
    assert pstore.verify_peer("node0", body, jstore.sign_raw(body))
    assert not pstore.verify_peer("node1", body, jstore.sign_raw(body))


@pytest.mark.parametrize("kind", ["sign", "kg", "rs"])
def test_manifest_body_equals_jax(kind, identities):
    _r, rb = _rand(300)
    _, _, init = identities
    reqs = []
    for i in range(4):
        if kind == "sign":
            m = pw.SignTxMessage("secp256k1", f"w{i}", "eth", f"t{i}", rb(32))
        elif kind == "kg":
            m = pw.GenerateKeyMessage(f"w{i}")
        else:
            m = pw.ResharingMessage(f"w{i}", 1, "ed25519")
        m.signature = init.sign(m.raw())
        reqs.append({"msg": m.to_json(), "reply": f"_inbox.{i}" if kind == "sign" else ""})
        # the claim key each package derives from the decoded request
        jm = {"sign": jw.SignTxMessage, "kg": jw.GenerateKeyMessage,
              "rs": jw.ResharingMessage}[kind].from_json(m.to_json())
        assert pbs._entry_key(kind, m) == jbs._entry_key(kind, jm)
    for cohorts in (1, 2):
        body = pbs._manifest_body("b1d", "node1", reqs, kind, cohorts)
        assert body == jbs._manifest_body("b1d", "node1", reqs, kind, cohorts)


def test_tracing_context_events_and_attribute_hygiene_match_jax():
    from mpcium_tpu.utils import tracing as jtr

    from mpcium_tpu_torch.utils import tracing as ptr

    attrs = {"batch": 4, "share": 123, "nonce_seed": b"x", "peer": object(), "n": None}
    assert ptr.clean_attrs(attrs) == jtr.clean_attrs(attrs)
    assert ptr.trace_id_for("sign:ecdsa:w:t") == jtr.trace_id_for("sign:ecdsa:w:t")
    assert ptr.wire_context() is None and ptr.span("x") is ptr.NOOP_SPAN
    spans, incidents = [], []
    ptr.enable(spans.append)
    ptr.set_incident_hook(lambda kind, node, a: incidents.append((kind, node, a)))
    try:
        with ptr.span("round:r1", node="node1", tid="s1", sender="node0") as outer:
            with ptr.span("phase:inner", batch=2) as inner:
                assert ptr.wire_context() == {"t": outer.trace_id, "s": inner.span_id}
            ptr.instant("intake", req_kind="sign")
            ptr.incident("shed", reason="deadline", share=1)
        ptr.emit("queue", 5, 9, node="node2", outcome="dispatched")
    finally:
        ptr.disable()
    by = {s["name"]: s for s in spans}
    assert by["phase:inner"]["parent_id"] == by["round:r1"]["span_id"]
    assert (by["phase:inner"]["node"], by["phase:inner"]["tid"]) == ("node1", "s1")
    assert by["intake"]["kind"] == "i" and by["queue"]["t0_ns"] == 5
    assert by["incident:shed"]["attrs"]["share"] == "<refused:secret-name>"
    assert incidents == [("shed", "local", {"reason": "deadline",
                                            "share": "<refused:secret-name>"})]
    assert ptr.wire_context() is None
