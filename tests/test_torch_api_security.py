"""The port's API-key manager (utils/api_security.py) against the JAX
package's, on the CPU.

The same operation sequence under one fixed clock, with `secrets` patched
in both modules to the same deterministic draws: equal records,
`AuthResult`s, rate limiting, rotation, revocation, listings and expiry
cleanup, and key files of the same bytes.  A key file written by either
package loads in the other and authenticates there.
"""

import dataclasses
import itertools

import pytest

from ai_crypto_trader_tpu.utils import api_security as ja
from ai_crypto_trader_tpu_torch.utils import api_security as ta


class Clock:
    def __init__(self):
        self.t = 1_000.0

    def __call__(self):
        return self.t


class FakeSecrets:
    """Deterministic `token_hex` / `token_urlsafe` draws."""

    def __init__(self):
        self.n = itertools.count()

    def token_hex(self, nbytes):
        return f"{next(self.n):0{2 * nbytes}x}"

    def token_urlsafe(self, nbytes):
        return f"tok{next(self.n):04d}" + "A" * nbytes


def _script(mod, path, monkeypatch):
    """One fixed sequence of operations; what each returned, in order."""
    monkeypatch.setattr(mod, "secrets", FakeSecrets())
    clock = Clock()
    m = mod.APISecurityManager(path=str(path), now_fn=clock, rate_per_s=2.0, burst=3.0)
    L = mod.AccessLevel
    out = []

    def auth(key, scope="read"):
        out.append(("auth", scope, dataclasses.astuple(m.authenticate(key, scope))))

    a_id, a_key = m.create_api_key("alice", L.TRADE)
    b_id, b_key = m.create_api_key("bob", L.READ_ONLY, ttl_s=50.0)
    r_id, r_key = m.create_api_key("root", L.ADMIN)
    out.append(("created", a_id, a_key, b_id, b_key, r_id, r_key))
    auth(a_key, "trade")
    auth(b_key, "trade")                        # insufficient_access
    auth(r_key, "admin")
    auth("actt_not_a_key")                      # unknown_key
    for _ in range(4):                          # burst 3, then rate_limited
        auth(b_key)
    clock.t += 1.0                              # 2 tokens back
    auth(b_key)
    auth(b_key)
    auth(b_key)
    out.append(("rotate", m.rotate_key(a_id), m.rotate_key("missing")))
    auth(a_key, "trade")                        # revoked
    new_id, new_key = out[-2][1]
    auth(new_key, "trade")
    out.append(("revoke", m.revoke_key(r_id, reason="leaked"), m.revoke_key("missing")))
    auth(r_key, "admin")
    out.append(("list", m.list_user_keys("alice"), m.list_user_keys("nobody")))
    clock.t += 100.0                            # bob's 50 s key expires
    out.append(("cleanup", m.cleanup_expired_keys(), m.cleanup_expired_keys()))
    auth(b_key)
    clock.t = 1_000.0 + 91 * 86_400.0           # the default 90-day keys expire
    auth(new_key, "read")                       # expired at authentication
    out.append(("cleanup", m.cleanup_expired_keys()))
    out.append(("keys", m.keys))
    return out, path.read_bytes()


def test_operation_sequence_matches(tmp_path, monkeypatch):
    ref, ref_file = _script(ja, tmp_path / "jax" / "keys.json", monkeypatch)
    got, got_file = _script(ta, tmp_path / "torch" / "keys.json", monkeypatch)
    assert got == ref
    assert got_file == ref_file
    reasons = [o[2][3] for o in got if o[0] == "auth"]
    assert {"insufficient_access", "unknown_key", "rate_limited", "revoked", "expired"} \
        <= set(reasons)


def test_enums_and_scopes_match():
    assert [e.value for e in ta.KeyStatus] == [e.value for e in ja.KeyStatus]
    assert [e.value for e in ta.AccessLevel] == [e.value for e in ja.AccessLevel]
    assert {k.value: v for k, v in ta.LEVEL_SCOPES.items()} == \
        {k.value: v for k, v in ja.LEVEL_SCOPES.items()}
    assert [f.name for f in dataclasses.fields(ta.AuthResult)] == \
        [f.name for f in dataclasses.fields(ja.AuthResult)]


@pytest.mark.parametrize("writer,reader", [(ja, ta), (ta, ja)])
def test_key_files_load_across_packages(tmp_path, writer, reader):
    path = str(tmp_path / "keys.json")
    w = writer.APISecurityManager(path=path, now_fn=Clock())
    kid, key = w.create_api_key("carol", writer.AccessLevel.TRADE)
    w.revoke_key(w.create_api_key("dave")[0], reason="test")
    r = reader.APISecurityManager(path=path, now_fn=Clock())
    assert r.keys == w.keys
    assert dataclasses.astuple(r.authenticate(key, "trade")) == (True, kid, "carol", "")
    assert r.authenticate(key, "admin").reason == "insufficient_access"
