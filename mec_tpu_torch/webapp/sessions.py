"""HMAC-signed cookie sessions (Flask-equivalent, stdlib only).

A copy of mec_tpu/webapp/sessions.py over the port's Config, pinned to
it by tests/test_torch_webapp.py: a cookie either front door signs with
the same SECRET_KEY, the other reads.
Cookie value = base64url(json payload) . base64url(hmac_sha256(payload)).
Carries an absolute expiry (PERMANENT_SESSION_LIFETIME, 24 h like
reference config.py:17) and refreshes on each request
(SESSION_REFRESH_EACH_REQUEST).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
from typing import Any, Dict, Optional

from mec_tpu_torch.config import Config

COOKIE_NAME = 'session'


def _b64e(b: bytes) -> str:
    return base64.urlsafe_b64encode(b).rstrip(b'=').decode('ascii')


def _b64d(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + '=' * (-len(s) % 4))


def _sign(payload: bytes, secret: str) -> str:
    return _b64e(hmac.new(secret.encode('utf-8'), payload,
                          hashlib.sha256).digest())


class Session(dict):
    """A dict plus a modified flag; route code uses it like flask.session."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.modified = False

    def __setitem__(self, k, v):
        super().__setitem__(k, v)
        self.modified = True

    def pop(self, *a):
        self.modified = True
        return super().pop(*a)

    def clear(self):
        self.modified = True
        super().clear()

    def flash(self, message: str, category: str = 'info') -> None:
        msgs = list(self.get('_flashes', []))
        msgs.append([category, message])
        self['_flashes'] = msgs

    def pop_flashes(self):
        return self.pop('_flashes') if '_flashes' in self else []


def load_session(cookie_value: Optional[str],
                 secret: str = Config.SECRET_KEY) -> Session:
    if not cookie_value or '.' not in cookie_value:
        return Session()
    body, sig = cookie_value.rsplit('.', 1)
    try:
        payload = _b64d(body)
        # compare as bytes: compare_digest raises TypeError on non-ASCII
        # str input, and an attacker controls `sig` — a malformed cookie
        # must mean "no session", never an exception
        ok = hmac.compare_digest(_sign(payload, secret).encode('ascii'),
                                 sig.encode('utf-8'))
    except Exception:
        return Session()
    if not ok:
        return Session()
    try:
        data: Dict[str, Any] = json.loads(payload)
    except json.JSONDecodeError:
        return Session()
    if data.get('_exp', 0) < time.time():
        return Session()
    data.pop('_exp', None)
    return Session(data)


def dump_session(session: Session,
                 secret: str = Config.SECRET_KEY) -> str:
    data = dict(session)
    data['_exp'] = time.time() + \
        Config.PERMANENT_SESSION_LIFETIME.total_seconds()
    payload = json.dumps(data, separators=(',', ':'),
                         sort_keys=True).encode('utf-8')
    return f'{_b64e(payload)}.{_sign(payload, secret)}'
