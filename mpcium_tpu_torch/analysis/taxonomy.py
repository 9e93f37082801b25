"""The secret taxonomy: which identifiers name secret material (the
port's copy of :func:`is_secret_name` from the JAX package's
``analysis/taxonomy.py``).

An identifier is secret when any of its snake_case tokens is a secret
token (``share``, ``seed``, ``pad``, ``nonce``, ``sk``, ``secret``,
``passphrase``, ``password``, ``otk``, ``priv``, ``token``) or it ends in
``_key``/``_keys`` — unless a *public* token exempts it (``pub_key``,
``public_key``, ``wallet_id`` are data, not secrets). ``utils/log.py``
redacts such objects from log lines and ``utils/tracing.py`` refuses
span attributes so named. The secret-hygiene rules (MPL1xx) and the
taint pass (MPF7xx) of ``analysis/`` read the same names, with the
per-file ``# mpclint: secret`` annotations merged in.
"""
from __future__ import annotations

import re
from typing import Iterable, Set

# tokens that make an identifier secret on their own
SECRET_TOKENS: Set[str] = {
    "sk",
    "share",
    "shares",
    "subshare",
    "subshares",
    "seed",
    "seeds",
    "pad",
    "pads",
    "nonce",
    "nonces",
    "secret",
    "secrets",
    "passphrase",
    "password",
    "otk",
    "priv",
    "privkey",
    "token",
}
# identifiers ending in _key / _keys are AEAD/derived keys ⇒ secret
_KEY_SUFFIX_RE = re.compile(r".*_keys?$")
# tokens that mark an identifier as public/non-secret even when a secret
# token also matches ("pub_key", "public_key_share", "wallet_share_count")
PUBLIC_TOKENS: Set[str] = {
    "pub",
    "public",
    "pubkey",
    "wallet",
    "tx",
    "topic",
    "session",
    "batch",
    "id",
    "ids",
    "name",
    "names",
    "count",
    "hashed",
    "len",
    "path",
    "verify",
}
# exact names that look secret by token but are known-module/known-public
_EXEMPT_EXACT: Set[str] = {
    "secrets",  # the stdlib entropy module, not a value
    "_secrets",
    "token_bytes",  # secrets.token_bytes attribute chains
    "token_hex",
    "token_matches",
    "hash_token",
}

_TOKEN_SPLIT_RE = re.compile(r"[^a-zA-Z0-9]+")


def tokens(name: str) -> Set[str]:
    """snake_case/camelCase-insensitive token set of an identifier."""
    name = name.strip("_")
    # split snake_case, then lower (camelCase is rare in this codebase)
    return {t.lower() for t in _TOKEN_SPLIT_RE.split(name) if t}


def is_secret_name(name: str, extra: Iterable[str] = ()) -> bool:
    """True when ``name`` denotes secret material under the taxonomy or
    the per-file ``# mpclint: secret`` annotation set ``extra``."""
    if not name:
        return False
    if name in extra:
        return True
    if name in _EXEMPT_EXACT:
        return False
    toks = tokens(name)
    if toks & PUBLIC_TOKENS:
        return False
    if toks & SECRET_TOKENS:
        return True
    if _KEY_SUFFIX_RE.fullmatch(name) or name in ("key32",):
        return True
    return False


# identifiers whose == / != comparison must be constant-time: MAC tags,
# digests, signatures over secrets, tokens (MPL103)
COMPARE_SENSITIVE_TOKENS: Set[str] = {
    "tag",
    "mac",
    "hmac",
    "digest",
    "token",
}


def is_compare_sensitive(name: str, extra: Iterable[str] = ()) -> bool:
    if is_secret_name(name, extra):
        return True
    return bool(tokens(name) & COMPARE_SENSITIVE_TOKENS)
