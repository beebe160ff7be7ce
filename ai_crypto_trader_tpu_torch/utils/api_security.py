"""API-key security manager.

The port's own copy of `ai_crypto_trader_tpu/utils/api_security.py:28-155`
(APISecurityManager, `services/utils/api_security.py`): key issuance with
access levels (:25-60, :146-220), hashed-at-rest storage (:132),
authentication with status/expiry/permission checks (:222-317), rotation
(:318), revocation (:372-407), per-user listings (:412), expired-key
cleanup (:429), and per-key rate limiting — persisted to a JSON file (the
JAX package's format, byte for byte) instead of Redis, with the port's
token-bucket limiter and an injected clock.  Host-only.

Keys are stored only as SHA-256 hashes; plaintext appears exactly once, in
the create/rotate return value.
"""

from __future__ import annotations

import enum
import hashlib
import json
import os
import secrets
import time
from dataclasses import dataclass, field

from ai_crypto_trader_tpu_torch.utils.rate_limiter import TokenBucket


class KeyStatus(enum.Enum):
    ACTIVE = "active"
    REVOKED = "revoked"
    EXPIRED = "expired"


class AccessLevel(enum.Enum):
    READ_ONLY = "read_only"
    TRADE = "trade"
    ADMIN = "admin"


# access level → permitted scopes (authenticate's permission check)
LEVEL_SCOPES = {
    AccessLevel.READ_ONLY: {"read"},
    AccessLevel.TRADE: {"read", "trade"},
    AccessLevel.ADMIN: {"read", "trade", "admin"},
}


@dataclass
class AuthResult:
    ok: bool
    key_id: str | None = None
    user_id: str | None = None
    reason: str = ""


@dataclass
class APISecurityManager:
    path: str | None = None
    default_ttl_s: float = 90 * 86_400.0
    rate_per_s: float = 10.0
    burst: float = 20.0
    now_fn: any = time.time
    keys: dict = field(default_factory=dict)       # key_id -> record
    _buckets: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.path and os.path.exists(self.path):
            with open(self.path) as f:
                self.keys = json.load(f)

    def _persist(self):
        if self.path:
            os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
            with open(self.path, "w") as f:
                json.dump(self.keys, f, indent=2)

    @staticmethod
    def _hash(api_key: str) -> str:
        return hashlib.sha256(api_key.encode()).hexdigest()

    def create_api_key(self, user_id: str,
                       level: AccessLevel = AccessLevel.READ_ONLY,
                       ttl_s: float | None = None) -> tuple[str, str]:
        """Returns (key_id, plaintext_key) — plaintext is never stored."""
        key_id = secrets.token_hex(8)
        plaintext = f"actt_{secrets.token_urlsafe(32)}"
        self.keys[key_id] = {
            "key_id": key_id,
            "user_id": user_id,
            "key_hash": self._hash(plaintext),
            "level": level.value,
            "status": KeyStatus.ACTIVE.value,
            "created_at": self.now_fn(),
            "expires_at": self.now_fn() + (ttl_s or self.default_ttl_s),
            "last_used_at": None,
        }
        self._persist()
        return key_id, plaintext

    def authenticate(self, api_key: str, scope: str = "read") -> AuthResult:
        """Hash-lookup + status/expiry/permission/rate checks (:222-317)."""
        h = self._hash(api_key)
        rec = next((r for r in self.keys.values() if r["key_hash"] == h), None)
        if rec is None:
            return AuthResult(False, reason="unknown_key")
        if rec["status"] != KeyStatus.ACTIVE.value:
            return AuthResult(False, rec["key_id"], rec["user_id"],
                              reason=rec["status"])
        if self.now_fn() >= rec["expires_at"]:
            rec["status"] = KeyStatus.EXPIRED.value
            self._persist()
            return AuthResult(False, rec["key_id"], rec["user_id"],
                              reason="expired")
        if scope not in LEVEL_SCOPES[AccessLevel(rec["level"])]:
            return AuthResult(False, rec["key_id"], rec["user_id"],
                              reason="insufficient_access")
        bucket = self._buckets.setdefault(
            rec["key_id"], TokenBucket(self.rate_per_s, self.burst,
                                       now_fn=self.now_fn))
        if not bucket.try_acquire():
            return AuthResult(False, rec["key_id"], rec["user_id"],
                              reason="rate_limited")
        rec["last_used_at"] = self.now_fn()
        return AuthResult(True, rec["key_id"], rec["user_id"])

    def rotate_key(self, key_id: str) -> tuple[str, str] | None:
        """Revoke + reissue for the same user/level (:318-371)."""
        rec = self.keys.get(key_id)
        if rec is None:
            return None
        self.revoke_key(key_id, reason="rotated")
        return self.create_api_key(rec["user_id"], AccessLevel(rec["level"]))

    def revoke_key(self, key_id: str, reason: str = "manual") -> bool:
        rec = self.keys.get(key_id)
        if rec is None:
            return False
        rec["status"] = KeyStatus.REVOKED.value
        rec["revoke_reason"] = reason
        self._persist()
        return True

    def list_user_keys(self, user_id: str) -> list[dict]:
        return [dict(r) for r in self.keys.values() if r["user_id"] == user_id]

    def cleanup_expired_keys(self) -> int:
        n = 0
        for rec in self.keys.values():
            if (rec["status"] == KeyStatus.ACTIVE.value
                    and self.now_fn() >= rec["expires_at"]):
                rec["status"] = KeyStatus.EXPIRED.value
                n += 1
        if n:
            self._persist()
        return n
