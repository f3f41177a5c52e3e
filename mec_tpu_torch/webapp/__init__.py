"""The web service (werkzeug WSGI, jinja2 for the HTML pages) over the
port's engine.

The port's copy of mec_tpu/webapp: the same routes and contracts, one
process owning the card and a single EmotionEngine, with a threaded WSGI
front end; sessions are HMAC-signed cookies, users and history live in
sqlite3 (database/), passwords hash with scrypt. `python -m
mec_tpu_torch serve` starts it (webapp/serve.py).
"""

from mec_tpu_torch.webapp.app import create_app

__all__ = ['create_app']
