"""In-memory sliding-window rate limiter.

A copy of mec_tpu/webapp/ratelimit.py, pinned to it by
tests/test_torch_webapp.py. Covers the reference's Flask-Limiter rules
(reference app.py:63-75,130,156): default '200 per day; 50 per hour',
register '3 per hour', login '5 per 15 minutes'. Keyed by client
address; windows are deques of timestamps pruned on access.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict, deque
from typing import Deque, Dict, Sequence, Tuple

Rule = Tuple[int, float]  # (max_requests, window_seconds)


def parse_rules(spec: str, fallback: Sequence[Rule]) -> Sequence[Rule]:
    """Parse 'count/window_seconds' pairs, e.g. '200/86400,50/3600'.
    Malformed specs fall back (misconfig must not take the service to
    an unlimited or all-denied state)."""
    if not spec.strip():
        return fallback
    try:
        rules = []
        for part in spec.split(','):
            n, w = part.split('/')
            n, w = int(n), float(w)
            if n <= 0 or w <= 0:
                raise ValueError(part)
            rules.append((n, w))
        return tuple(rules)
    except (ValueError, TypeError):
        return fallback


def _env_rules(name: str, fallback: Sequence[Rule]) -> Sequence[Rule]:
    import os
    return parse_rules(os.environ.get(name, ''), fallback)


# The reference's Flask-Limiter rules (reference app.py:63-75,130,156),
# overridable per deployment via MEC_RATELIMIT_* env specs.
DEFAULT_RULES: Sequence[Rule] = _env_rules(
    'MEC_RATELIMIT_DEFAULT', ((200, 86400.0), (50, 3600.0)))
REGISTER_RULES: Sequence[Rule] = _env_rules(
    'MEC_RATELIMIT_REGISTER', ((3, 3600.0),))
LOGIN_RULES: Sequence[Rule] = _env_rules(
    'MEC_RATELIMIT_LOGIN', ((5, 900.0),))


class RateLimiter:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        # windows are keyed by (key, limit, window) — the RULE identity,
        # not its index: the same key is checked against DEFAULT_RULES by
        # the app dispatcher AND against LOGIN/REGISTER_RULES inside the
        # handler, and index-keying made those share deques (a single GET
        # of /login consumed the 5/15-min login budget)
        self._hits: Dict[Tuple[str, int, float],
                         Deque[float]] = defaultdict(deque)

    def allow(self, key: str, rules: Sequence[Rule] = DEFAULT_RULES) -> bool:
        if not self.enabled:
            return True
        now = time.time()
        with self._lock:
            for limit, window in rules:
                # .get, not defaultdict access: the check loop must not
                # materialize entries for keys that end up denied, or a
                # scan from many addresses grows the dict forever
                q = self._hits.get((key, limit, window))
                if q is not None:
                    while q and q[0] <= now - window:
                        q.popleft()
                    if not q:
                        del self._hits[(key, limit, window)]  # expired
                        q = None
                if q is not None and len(q) >= limit:
                    return False
            for limit, window in rules:
                self._hits[(key, limit, window)].append(now)
        return True

    def reset(self) -> None:
        with self._lock:
            self._hits.clear()
