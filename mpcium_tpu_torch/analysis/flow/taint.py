"""MPF7xx: secret-flow taint policy.

Sources
  - functions whose return is marked ``Secret[...]`` (utils/annotations):
    share-store reads, WAL unseal, DKG subshare output, nonce/PRG
    derivation — the engine picks these up from the signature;
  - a curated fid list for sources whose signatures stay unannotated;
  - names that the shared secret taxonomy (analysis/taxonomy.py) calls
    secret (``sk``, ``share``, ``seed``, ``nonce``, …), including
    ``# mpclint: secret``-declared extras.

Sinks
  - MPF701 — logging calls (``log.info`` / ``logger.*`` / ``logging.*``);
  - MPF702 — exception construction in ``raise`` (tainted data formatted
    into an exception message escapes via handlers that log ``str(e)``);
  - MPF703 — persistence/egress of *unsealed* taint: pickle dumps,
    direct file writes, transport publish/broadcast payloads (the bus
    channel-encrypts below this line, but application payloads are the
    documented protection boundary: shares must be sealed or reduced to
    protocol math before they reach the wire API).

Sanitizers (cut taint to CLEAN)
  - AEAD sealing (``seal``/``_seal``/``encrypt`` methods — kvstore,
    session WAL, transport channel, Paillier);
  - hash commitments and KDFs (``hashlib.*``, ``hmac.*``, the native
    batch SHA kernels, ``challenge_hashes``);
  - an explicit ``# mpcflow: declassified`` on the assignment line
    (handled by the engine via ParsedFile.declassified).

Findings carry the full source→sink call chain in the message; the
fingerprint stays line-free (``rule:path:symbol:sink<-origin``).
"""
from __future__ import annotations

import ast
from typing import List, Optional, Tuple

from ..core import Finding
from ..taxonomy import is_secret_name
from .callgraph import CallGraph
from .engine import FlowEngine, Policy
from .symbols import FuncInfo, ProjectIndex

# files the taint pass skips: the analysis package talks about secrets
# in every other line, and tests exercise leaky patterns on purpose
SKIP_PREFIXES = ("mpcium_tpu_torch/analysis/",)

# drill/chaos "seeds" are public replay handles, not key material —
# secret-name seeding is off for the fault-injection package
_PUBLIC_SEED_PREFIXES = ("mpcium_tpu_torch/faults/",)

# attrs that stay clean even on a secret base object: a KeygenShare is
# tainted, but its roster/threshold/public key are wire-public fields
_PUBLIC_ATTRS = {
    "participants", "public_key", "vss_commitments", "threshold",
    "epoch", "key_type", "is_reshared", "describe", "rules",
    "error_reason", "result_type", "session_id", "wallet_id",
}

# sources whose signatures we keep unannotated (fid suffix match:
# "<rel>::<qualname>")
SOURCE_FIDS = {
    "mpcium_tpu_torch/store/kvstore.py::EncryptedFileKV.get":
        "encrypted share-store read",
    "mpcium_tpu_torch/store/kvstore.py::EncryptedFileKV.unseal":
        "AEAD unseal",
    "mpcium_tpu_torch/store/kvstore.py::EncryptedFileKV._open":
        "AEAD unseal",
}

_LOG_OBJECTS = {"log", "logger", "logging", "_logger", "_log"}
_LOG_FUNCS = {
    "debug", "info", "warning", "warn", "error", "exception",
    "critical", "fatal",
}

_HASH_TAILS = {
    "sha256", "sha512", "sha1", "md5", "blake2b", "blake2s",
    "sha3_256", "sha3_512", "scrypt", "pbkdf2_hmac",
    "batch_sha256", "batch_sha512", "challenge_hashes",
    "hashed_name", "hash_token", "compare_digest",
}
# AEAD / encryption boundaries: tainted plaintext in, safe blob out —
# plus outputs that are public by construction: signatures, ZK proofs,
# hash commitments
_SEAL_QUALNAME_TAILS = {
    "seal", "_seal", "encrypt", "encrypt_private_bytes",
    "sign_raw", "prove", "commit",
}
_SANITIZER_FIDS = {
    # Ed25519 envelope signing: the signature is a public output
    "mpcium_tpu_torch/identity/identity.py::InitiatorKey.sign",
}

_WIRE_TAILS = {"publish", "publish_with_reply", "broadcast", "send_direct"}

_FILE_WRITE_DOTTED = {"os.write"}
_FILE_WRITE_TAILS = {"write_bytes", "write_text"}

_PICKLE_DOTTED = {
    "pickle.dump", "pickle.dumps", "marshal.dump", "marshal.dumps",
    "np.save", "np.savez", "numpy.save", "numpy.savez",
}


class TaintPolicy(Policy):
    def __init__(self, index: ProjectIndex):
        self.index = index

    # -- sources -------------------------------------------------------

    def source_call(self, fid: str) -> Optional[str]:
        label = SOURCE_FIDS.get(fid)
        if label:
            return label
        return None

    def source_name(self, name: str, fi: FuncInfo) -> Optional[str]:
        if fi.pf.rel.startswith(_PUBLIC_SEED_PREFIXES):
            return None
        if is_secret_name(name, fi.pf.extra_secrets):
            return f"secret-named '{name}'"
        return None

    def public_attr(self, name: str) -> bool:
        return name in _PUBLIC_ATTRS

    # -- sanitizers ----------------------------------------------------

    def sanitizer(self, fid: Optional[str], dotted: str) -> bool:
        tail = dotted.rsplit(".", 1)[-1] if dotted else ""
        if dotted.startswith(("hashlib.", "hmac.")):
            return True
        if tail in _HASH_TAILS:
            return True
        if fid is not None:
            if fid in _SANITIZER_FIDS:
                return True
            # split off the path first: a module-level fn fid ends
            # "<file>.py::name" and a plain rsplit('.') would yield
            # "py::name" instead of "name"
            qn = fid.split("::", 1)[-1]
            if qn.rsplit(".", 1)[-1] in _SEAL_QUALNAME_TAILS:
                return True
        # unresolved method call spelled like a sealer ('.seal(', '.encrypt(')
        if fid is None and tail in _SEAL_QUALNAME_TAILS:
            return True
        return False

    # -- sinks ---------------------------------------------------------

    def sink(
        self, call: ast.Call, dotted: str, fi: FuncInfo, fid: Optional[str]
    ) -> Optional[Tuple[str, str, str]]:
        tail = dotted.rsplit(".", 1)[-1] if dotted else ""
        base = dotted.rsplit(".", 1)[0] if "." in dotted else ""
        if tail in _LOG_FUNCS and (
            base in _LOG_OBJECTS or base.split(".")[-1] in _LOG_OBJECTS
        ):
            return ("MPF701", "log", dotted)
        if dotted in _PICKLE_DOTTED:
            return ("MPF703", "persist", dotted)
        if dotted in _FILE_WRITE_DOTTED or tail in _FILE_WRITE_TAILS:
            return ("MPF703", "persist", dotted or tail)
        if tail in _WIRE_TAILS and isinstance(call.func, ast.Attribute):
            return ("MPF703", "wire", dotted or tail)
        return None

    def raise_is_sink(self) -> Optional[Tuple[str, str]]:
        return ("MPF702", "raise")


def run_taint(index: ProjectIndex, graph: CallGraph) -> List[Finding]:
    """MPF7xx sweep over an already-built index/graph."""
    policy = TaintPolicy(index)
    engine = FlowEngine(index, graph, policy)
    findings = engine.run()
    return [
        f for f in findings if not f.path.startswith(SKIP_PREFIXES)
    ]
