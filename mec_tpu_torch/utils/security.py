"""Input sanitization and validation helpers for the web app.

A copy of mec_tpu/utils/security.py (importing mec_tpu imports jax),
pinned to it by tests/test_torch_webapp.py. Same surface as reference
security.py (sanitize_text :9-35, sanitize_filename :38-65,
validate_email/username/password :68-137, is_safe_redirect_url
:140-168).
"""

from __future__ import annotations

import os
import re
from typing import Tuple
from urllib.parse import urlparse

MAX_TEXT_LEN = 10_000

_CTRL = re.compile(r'[\x00-\x08\x0b\x0c\x0e-\x1f\x7f]')
_EMAIL = re.compile(r'^[A-Za-z0-9._%+-]+@[A-Za-z0-9.-]+\.[A-Za-z]{2,}$')
_USERNAME = re.compile(r'^[A-Za-z0-9_.-]{3,100}$')
_FILENAME_BAD = re.compile(r'[^A-Za-z0-9_.-]')


def sanitize_text(text: str) -> str:
    """Strip control characters, normalize whitespace, cap at 10k chars."""
    if not isinstance(text, str):
        return ''
    text = _CTRL.sub('', text)
    return text[:MAX_TEXT_LEN].strip()


def sanitize_filename(filename: str) -> str:
    """Traversal-safe filename: basename only, safe charset, non-empty."""
    if not filename:
        return 'upload'
    base = os.path.basename(filename.replace('\\', '/'))
    base = _FILENAME_BAD.sub('_', base).lstrip('.')
    return base or 'upload'


def validate_email(email: str) -> Tuple[bool, str]:
    if not email or len(email) > 150:
        return False, 'Email is required (max 150 chars).'
    if not _EMAIL.match(email):
        return False, 'Invalid email address.'
    return True, ''


def validate_username(username: str) -> Tuple[bool, str]:
    if not username:
        return False, 'Username is required.'
    if not _USERNAME.match(username):
        return False, ('Username must be 3-100 chars of letters, digits, '
                       'dot, dash, or underscore.')
    return True, ''


def validate_password(password: str) -> Tuple[bool, str]:
    if not password or len(password) < 8:
        return False, 'Password must be at least 8 characters.'
    if len(password) > 256:
        return False, 'Password too long.'
    return True, ''


def is_safe_redirect_url(url: str, host: str = '') -> bool:
    """Only same-host or relative redirect targets."""
    if not url:
        return False
    # browsers normalize backslashes to slashes, so '/\\evil.com' is a
    # scheme-relative external URL that urlparse does not flag; control
    # characters can smuggle headers
    if '\\' in url or any(ord(c) < 0x20 for c in url):
        return False
    parsed = urlparse(url)
    if parsed.scheme and parsed.scheme not in ('http', 'https'):
        return False
    if parsed.netloc and parsed.netloc != host:
        return False
    return not url.startswith('//')
