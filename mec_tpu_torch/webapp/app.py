"""The WSGI application: the port's copy of mec_tpu/webapp/app.py.

Route for route the JAX package's app (itself the reference Flask app's,
reference app.py:124-626; catalog in SURVEY.md §3): HTML — /, /register,
/login, /logout, /dashboard, /predict/{speech,text,image,multimodal},
/history, /history/export.csv, /statistics; JSON — /api/{register,login,
logout}, /api/user/profile, /api/predict/{speech,text,image,multimodal},
/api/predictions (GET/DELETE), /api/statistics, /api/metrics(/stream);
413 handler. Every predict route goes through the process-wide engine of
mec_tpu_torch.serving.engine (get_engine on `device`, 'cuda' unless the
caller asks for 'cpu') and its micro-batcher. The port's Config,
database, batcher, timer and security helpers stand in for the JAX
package's, which cannot be imported here (importing mec_tpu imports
jax). The HTML templates and static files are read by path from
mec_tpu/webapp/, one copy for both front doors; jinja2 is imported at the
first HTML render only, so the JSON API needs werkzeug alone.
tests/test_torch_webapp.py drives this app and the JAX one with the same
requests.
"""
from __future__ import annotations

import csv
import hmac
import io
import json
import logging
import os
import secrets
import uuid
from functools import wraps
from typing import Any, Callable, Dict, Optional
from urllib.parse import urlencode

from werkzeug.exceptions import (HTTPException, NotFound,
                                 RequestEntityTooLarge, TooManyRequests)
from werkzeug.routing import Map, Rule
from werkzeug.utils import secure_filename
from werkzeug.wrappers import Request, Response

from mec_tpu_torch.config import _REPO_ROOT, Config
from mec_tpu_torch.database import get_db
from mec_tpu_torch.serving.batcher import BatchOverloaded
from mec_tpu_torch.utils.logging_config import setup_logging
from mec_tpu_torch.utils.profiling import timer
from mec_tpu_torch.utils.security import (is_safe_redirect_url,
                                          sanitize_text, validate_email,
                                          validate_password,
                                          validate_username)
from mec_tpu_torch.webapp import ratelimit
from mec_tpu_torch.webapp.sessions import (COOKIE_NAME, Session,
                                           dump_session, load_session)

# the HTML templates and static files are the JAX package's, read as
# data: one copy of the pages serves both front doors
_ASSETS = os.path.join(_REPO_ROOT, 'mec_tpu', 'webapp')

URL_MAP = Map([
    Rule('/', endpoint='index'),
    Rule('/register', endpoint='register', methods=['GET', 'POST']),
    Rule('/login', endpoint='login', methods=['GET', 'POST']),
    Rule('/logout', endpoint='logout'),
    Rule('/dashboard', endpoint='dashboard'),
    Rule('/predict/speech', endpoint='predict_speech',
         methods=['GET', 'POST']),
    Rule('/predict/text', endpoint='predict_text', methods=['GET', 'POST']),
    Rule('/predict/image', endpoint='predict_image',
         methods=['GET', 'POST']),
    Rule('/predict/multimodal', endpoint='predict_multimodal',
         methods=['GET', 'POST']),
    Rule('/history', endpoint='history'),
    Rule('/history/export.csv', endpoint='export_history_csv'),
    Rule('/statistics', endpoint='statistics_page'),
    Rule('/static/<path:filename>', endpoint='static_file'),
    Rule('/api/register', endpoint='api_register', methods=['POST']),
    Rule('/api/login', endpoint='api_login', methods=['POST']),
    Rule('/api/logout', endpoint='api_logout', methods=['POST']),
    Rule('/api/user/profile', endpoint='api_user_profile'),
    Rule('/api/predict/speech', endpoint='api_predict_speech',
         methods=['POST']),
    Rule('/api/predict/text', endpoint='api_predict_text',
         methods=['POST']),
    Rule('/api/predict/image', endpoint='api_predict_image',
         methods=['POST']),
    Rule('/api/predict/multimodal', endpoint='api_predict_multimodal',
         methods=['POST']),
    Rule('/api/predictions', endpoint='api_predictions'),
    Rule('/api/predictions/<int:pid>', endpoint='api_delete_prediction',
         methods=['DELETE']),
    Rule('/api/statistics', endpoint='api_statistics'),
    Rule('/api/metrics', endpoint='api_metrics'),
    Rule('/api/metrics/stream', endpoint='api_metrics_stream'),
])


def jsonify(data: Any, status: int = 200) -> Response:
    return Response(json.dumps(data), status=status,
                    mimetype='application/json')


def login_required(fn: Callable) -> Callable:
    @wraps(fn)
    def wrapper(self, request, session, **kw):
        if 'user_id' not in session:
            session.flash('Please log in to continue.', 'warning')
            return self.redirect('/login', session)
        return fn(self, request, session, **kw)
    return wrapper


def api_login_required(fn: Callable) -> Callable:
    @wraps(fn)
    def wrapper(self, request, session, **kw):
        if 'user_id' not in session:
            return jsonify({'error': 'unauthorized'}, 401)
        return fn(self, request, session, **kw)
    return wrapper


def clean_result(result: Dict[str, Any]) -> Dict[str, Any]:
    """Drop engine-internal keys (leading underscore) before responding —
    the public contract is {emotion, confidence, all_probabilities}
    (reference speech_inference.py:71-77)."""
    for k in [k for k in result if k.startswith('_')]:
        result.pop(k)
    return result


def allowed_file(filename: str, kind: str) -> bool:
    """Extension allowlist (reference app.py:100-108)."""
    if not filename or '.' not in filename:
        return False
    ext = filename.rsplit('.', 1)[1].lower()
    if kind == 'audio':
        return ext in Config.ALLOWED_AUDIO_EXTENSIONS
    if kind == 'image':
        return ext in Config.ALLOWED_IMAGE_EXTENSIONS
    return False


class EmotionApp:
    """WSGI app; one instance per process, shared across worker threads."""

    def __init__(self, db=None, engine=None, testing: bool = False,
                 models_dir: Optional[str] = None, device='cuda'):
        self.testing = testing
        self.db = db if db is not None else get_db()
        self._engine = engine
        self._batcher = None
        self._models_dir = models_dir
        self._device = device
        import threading
        self._init_lock = threading.Lock()
        # cap concurrent SSE metric streams — each pins a worker thread
        self._stream_slots = threading.BoundedSemaphore(
            int(os.environ.get('MEC_METRICS_STREAMS', '8')))
        self.limiter = ratelimit.RateLimiter(
            enabled=not testing and Config.RATELIMIT_ENABLED)
        self.log = setup_logging()
        self._jinja = None
        os.makedirs(Config.UPLOAD_FOLDER, exist_ok=True)

    @property
    def jinja(self):
        """The template environment, built at the first HTML render:
        jinja2 is imported there, so the JSON API serves without it."""
        if self._jinja is None:
            from jinja2 import (Environment, FileSystemLoader,
                                select_autoescape)
            env = Environment(
                loader=FileSystemLoader(os.path.join(_ASSETS, 'templates')),
                autoescape=select_autoescape(['html']))
            env.globals['config'] = Config
            self._jinja = env
        return self._jinja

    # ------------------------------------------------------------------
    @property
    def engine(self):
        if self._engine is None:
            with self._init_lock:
                if self._engine is None:
                    from mec_tpu_torch.serving.engine import get_engine
                    self._engine = get_engine(models_dir=self._models_dir,
                                              device=self._device)
        return self._engine

    @property
    def batcher(self):
        """Micro-batching queues: concurrent requests coalesce into one
        device dispatch (serving/batcher.py)."""
        if self._batcher is None:
            engine = self.engine  # resolve outside the lock (slow load)
            with self._init_lock:
                if self._batcher is None:
                    from mec_tpu_torch.serving.batcher import EngineBatcher
                    self._batcher = EngineBatcher(engine)
        return self._batcher

    # ------------------------------------------------------------------
    # plumbing
    # ------------------------------------------------------------------
    def render(self, session: Session, template: str, status: int = 200,
               **ctx) -> Response:
        ctx.setdefault('session', dict(session))
        ctx['flashes'] = session.pop_flashes()
        ctx['csrf_token'] = self._csrf_token(session)
        html = self.jinja.get_template(template).render(**ctx)
        return Response(html, status=status, mimetype='text/html')

    @staticmethod
    def redirect(location: str, session: Session) -> Response:
        return Response('', status=302, headers={'Location': location})

    def _csrf_token(self, session: Session) -> str:
        if '_csrf' not in session:
            session['_csrf'] = secrets.token_hex(16)
        return session['_csrf']

    def _check_csrf(self, request: Request, session: Session) -> bool:
        """HTML-form POSTs carry the session CSRF token
        (reference uses Flask-WTF CSRFProtect, app.py:56-61). Both sides
        must be present and non-empty: a fresh session has no '_csrf'
        yet, and None == None must NOT pass (login CSRF)."""
        if self.testing or not Config.WTF_CSRF_ENABLED:
            return True
        token = request.form.get('csrf_token')
        want = session.get('_csrf')
        # compare as bytes: compare_digest raises TypeError on non-ASCII
        # str, and the form field is attacker-controlled — a garbage
        # token must mean 400, not 500
        return bool(token and want) and hmac.compare_digest(
            token.encode('utf-8'), str(want).encode('utf-8'))

    def _save_upload(self, fileobj, kind: str) -> Optional[str]:
        if not (fileobj and fileobj.filename
                and allowed_file(fileobj.filename, kind)):
            return None
        # unique prefix: concurrent clients uploading the same filename
        # must not share a path — one request's save truncates the file
        # while another request's batch is decoding it (and even without
        # the race, user B's upload would replace user A's history file)
        fname = f'{uuid.uuid4().hex[:12]}_{secure_filename(fileobj.filename)}'
        path = os.path.join(Config.UPLOAD_FOLDER, fname)
        fileobj.save(path)
        return path

    def _multimodal_payload(self, audio_path, text, image_path):
        """Build the tri-modal batcher payload, decoding uploads HERE
        in the request thread (so batch formation never waits on host
        decode; the decodes release the GIL, so concurrent requests
        decode in parallel) — but only when the request is FULL
        tri-modal (the fused batch path consumes the arrays; partial
        requests fall back to per-modality path decoding, which would
        ignore them and decode twice) and only while the queue is
        shallow (beyond one full batch of backlog, queued predecoded
        tensors — ~0.5 MB/request — become their own memory-pressure
        mode, and a request about to be shed must not burn the decode
        CPU the backlog needs to drain)."""
        payload = {'audio_path': audio_path, 'text': text,
                   'image_path': image_path}
        if (audio_path and text and image_path
                and not self.batcher.multimodal.backlogged()
                and not self.batcher.multimodal.overloaded()):
            payload = self.engine.predecode_multimodal(payload)
        return payload

    def _submit(self, port, payload, *upload_paths):
        """Submit to a batcher port; on load shed, delete the uploads.

        A shed request produces no prediction record, so files written
        by _save_upload before the submit would be orphans — under
        sustained overload disk grows while the server returns 503s.
        """
        try:
            return port.submit(payload)
        except BatchOverloaded:
            for p in upload_paths:
                if p:
                    try:
                        os.unlink(p)
                    except OSError:
                        pass
            raise

    def _record(self, session: Session, input_type: str,
                result: Dict[str, Any], column: str,
                file_path: Optional[str] = None) -> None:
        if 'user_id' not in session:
            return
        self.db.save_prediction(
            user_id=session['user_id'], input_type=input_type,
            predicted_emotion=result['emotion'],
            confidence_score=result['confidence'],
            **{f'{column}_emotion': result['emotion'],
               f'{column}_confidence': result['confidence']},
            file_path=file_path)
        self.db.increment_emotion_stat(result['emotion'])

    # ------------------------------------------------------------------
    # WSGI entry
    # ------------------------------------------------------------------
    def __call__(self, environ, start_response):
        request = Request(environ)
        # force-HTTPS in production (reference app.py:77-83 Talisman
        # force_https): redirect plain-HTTP requests before any handler
        # runs; a TLS-terminating proxy announces https via
        # X-Forwarded-Proto. 302 matches Talisman's default.
        proto = request.headers.get('X-Forwarded-Proto', request.scheme)
        if Config.FORCE_HTTPS and proto != 'https':
            url = 'https://' + request.host + request.full_path.rstrip('?')
            response = Response('', status=302, headers={'Location': url})
            for k, v in Config.SECURITY_HEADERS.items():
                response.headers.setdefault(k, v)
            return response(environ, start_response)
        session = load_session(request.cookies.get(COOKIE_NAME))
        had_cookie = bool(request.cookies.get(COOKIE_NAME))
        # enforced by werkzeug WHILE parsing, so a chunked request with
        # no Content-Length header cannot stream an unbounded body past
        # the header-only check below (reference MAX_CONTENT_LENGTH,
        # reference config.py:48 / 413 handler app.py:637)
        request.max_content_length = Config.MAX_FILE_SIZE
        try:
            if (request.content_length or 0) > Config.MAX_FILE_SIZE:
                raise RequestEntityTooLarge()
            adapter = URL_MAP.bind_to_environ(environ)
            endpoint, args = adapter.match()
            # app-wide default limits, per endpoint per client address
            # (the reference's Flask-Limiter default '200/day; 50/hour',
            # reference app.py:63-75); register/login add stricter rules
            # inside their handlers
            # static assets are exempt: every page load fetches them,
            # so the 50/hour default budget would break page styling for
            # active users long before any HTML route limits trip
            if endpoint != 'static_file' and not self.limiter.allow(
                    f'{endpoint}:{request.remote_addr}',
                    ratelimit.DEFAULT_RULES):
                raise TooManyRequests('Rate limit exceeded')
            handler = getattr(self, endpoint)
            with timer.span(endpoint):
                response = handler(request, session, **args)
        except NotFound:
            response = self._error_response(request, session, 404,
                                            'Page not found')
        except RequestEntityTooLarge:
            response = self._error_response(request, session, 413,
                                            'File too large')
        except BatchOverloaded:
            # load shedding: the batcher's pending bound is hit — shed
            # THIS request with an explicit retry signal instead of
            # queueing work the device cannot catch up on
            response = self._error_response(
                request, session, 503,
                'Server overloaded, please retry')
            response.headers['Retry-After'] = '1'
        except HTTPException as e:
            response = self._error_response(request, session,
                                            e.code or 500, e.description)
        except Exception:  # degrade-don't-fail; log and 500
            self.log.exception('unhandled error')
            response = self._error_response(request, session, 500,
                                            'Internal server error')

        # SESSION_REFRESH_EACH_REQUEST (reference config.py): re-issue
        # the cookie on every request that carries a session so the 24 h
        # expiry slides with activity instead of being absolute from the
        # last session WRITE
        refresh = bool(session) and Config.SESSION_REFRESH_EACH_REQUEST
        if session.modified or (session and not had_cookie) or refresh:
            response.set_cookie(
                COOKIE_NAME, dump_session(session),
                httponly=Config.SESSION_COOKIE_HTTPONLY,
                secure=Config.SESSION_COOKIE_SECURE,
                samesite=Config.SESSION_COOKIE_SAMESITE,
                max_age=int(
                    Config.PERMANENT_SESSION_LIFETIME.total_seconds()))
        for k, v in Config.SECURITY_HEADERS.items():
            response.headers.setdefault(k, v)
        return response(environ, start_response)

    def _error_response(self, request: Request, session: Session,
                        status: int, message: str) -> Response:
        if request.path.startswith('/api/'):
            return jsonify({'error': message}, status)
        try:
            return self.render(session, 'error.html', status=status,
                               code=status, message=message)
        except Exception:
            return Response(message, status=status, mimetype='text/plain')

    # ------------------------------------------------------------------
    # HTML routes
    # ------------------------------------------------------------------
    def index(self, request, session):
        return self.render(session, 'index.html')

    def static_file(self, request, session, filename):
        root = os.path.join(_ASSETS, 'static')
        path = os.path.normpath(os.path.join(root, filename))
        # containment needs the trailing separator: bare startswith(root)
        # would also admit a sibling 'static-anything/' directory
        if not path.startswith(root + os.sep) or not os.path.isfile(path):
            raise NotFound()
        mime = ('text/css' if path.endswith('.css')
                else 'application/javascript' if path.endswith('.js')
                else 'application/octet-stream')
        with open(path, 'rb') as f:
            return Response(f.read(), mimetype=mime)

    def register(self, request, session):
        if request.method == 'POST':
            if not self.limiter.allow(f'register:{request.remote_addr}',
                                      ratelimit.REGISTER_RULES):
                return self._error_response(request, session, 429,
                                            'Too many registrations')
            if not self._check_csrf(request, session):
                return self._error_response(request, session, 400,
                                            'CSRF token missing')
            username = sanitize_text(request.form.get('username') or '')
            email = sanitize_text(request.form.get('email') or '')
            password = request.form.get('password') or ''
            for ok, msg in (validate_username(username),
                            validate_email(email),
                            validate_password(password)):
                if not ok:
                    session.flash(msg, 'danger')
                    return self.render(session, 'register.html')
            if self.db.find_user(username, email):
                session.flash('Username or email already exists.', 'danger')
                return self.render(session, 'register.html')
            user = self.db.create_user(username, email, password)
            session['user_id'] = user.id
            session['username'] = user.username
            session.flash('Registration successful. Welcome!', 'success')
            return self.redirect('/dashboard', session)
        return self.render(session, 'register.html')

    def login(self, request, session):
        if request.method == 'POST':
            if not self.limiter.allow(f'login:{request.remote_addr}',
                                      ratelimit.LOGIN_RULES):
                return self._error_response(request, session, 429,
                                            'Too many login attempts')
            if not self._check_csrf(request, session):
                return self._error_response(request, session, 400,
                                            'CSRF token missing')
            username = request.form.get('username') or ''
            password = request.form.get('password') or ''
            user = self.db.find_user(username)
            if not user or not user.check_password(password):
                session.flash('Invalid username or password.', 'danger')
                return self.render(session, 'login.html')
            session['user_id'] = user.id
            session['username'] = user.username
            session.flash(f'Welcome back, {user.username}!', 'success')
            nxt = request.args.get('next', '')
            if nxt and is_safe_redirect_url(nxt, request.host):
                return self.redirect(nxt, session)
            return self.redirect('/dashboard', session)
        return self.render(session, 'login.html')

    def logout(self, request, session):
        session.clear()
        session.flash('You have been logged out.', 'info')
        return self.redirect('/', session)

    @login_required
    def dashboard(self, request, session):
        uid = session['user_id']
        recent = self.db.get_user_predictions(uid, limit=5)
        total = self.db.count_user_predictions(uid)
        dist = self.db.emotion_distribution(uid)
        most_common = max(dist, key=dist.get) if total else None
        return self.render(session, 'dashboard.html', recent=recent,
                           total_count=total, most_common=most_common,
                           chart_labels=list(dist.keys()),
                           chart_values=list(dist.values()))

    @login_required
    def predict_speech(self, request, session):
        if request.method == 'POST':
            if not self._check_csrf(request, session):
                return self._error_response(request, session, 400,
                                            'CSRF token missing')
            path = self._save_upload(request.files.get('audio_file'),
                                     'audio')
            if path:
                result = clean_result(
                    self._submit(self.batcher.speech, path, path))
                self._record(session, 'speech', result, 'speech', path)
                return self.render(session, 'results.html',
                                   modality='speech', result=result)
            session.flash('Invalid audio file.', 'danger')
        return self.render(session, 'speech_input.html')

    @login_required
    def predict_text(self, request, session):
        if request.method == 'POST':
            if not self._check_csrf(request, session):
                return self._error_response(request, session, 400,
                                            'CSRF token missing')
            text = request.form.get('text_input')
            if text:
                result = clean_result(self.batcher.text.submit(text))
                self._record(session, 'text', result, 'text')
                return self.render(session, 'results.html', modality='text',
                                   result=result, text=text)
            session.flash('Please enter some text.', 'warning')
        return self.render(session, 'text_input.html')

    @login_required
    def predict_image(self, request, session):
        if request.method == 'POST':
            if not self._check_csrf(request, session):
                return self._error_response(request, session, 400,
                                            'CSRF token missing')
            path = self._save_upload(request.files.get('image_file'),
                                     'image')
            if path:
                result = clean_result(
                    self._submit(self.batcher.image, path, path))
                self._record(session, 'image', result, 'image', path)
                return self.render(session, 'results.html',
                                   modality='image', result=result,
                                   image_path=path)
            session.flash('Invalid image file.', 'danger')
        return self.render(session, 'image_input.html')

    @login_required
    def predict_multimodal(self, request, session):
        if request.method == 'POST':
            if not self._check_csrf(request, session):
                return self._error_response(request, session, 400,
                                            'CSRF token missing')
            audio_path = self._save_upload(request.files.get('audio_file'),
                                           'audio')
            image_path = self._save_upload(request.files.get('image_file'),
                                           'image')
            text = request.form.get('text_input')
            payload = self._multimodal_payload(audio_path, text,
                                               image_path)
            results = self._submit(self.batcher.multimodal, payload,
                                   audio_path, image_path)
            self._save_multimodal(session, results)
            results = {k: clean_result(v) for k, v in results.items()}
            return self.render(session, 'results.html',
                               modality='multimodal', result=results,
                               image_path=image_path, text=text)
        return self.render(session, 'multimodal_input.html')

    def _save_multimodal(self, session: Session,
                         results: Dict[str, Dict]) -> None:
        if 'user_id' not in session:
            return
        if not results:
            # a request with zero inputs produced nothing — recording it
            # would put an all-NULL row into history/CSV export (the
            # reference does write that junk row; deliberate deviation)
            return
        top = (results.get('fusion') or results.get('speech')
               or results.get('text') or results.get('image') or {})
        self.db.save_prediction(
            user_id=session['user_id'], input_type='multimodal',
            predicted_emotion=top.get('emotion'),
            confidence_score=top.get('confidence'),
            speech_emotion=results.get('speech', {}).get('emotion'),
            text_emotion=results.get('text', {}).get('emotion'),
            image_emotion=results.get('image', {}).get('emotion'),
            speech_confidence=results.get('speech', {}).get('confidence'),
            text_confidence=results.get('text', {}).get('confidence'),
            image_confidence=results.get('image', {}).get('confidence'))
        fusion_label = (results.get('fusion') or {}).get('emotion')
        if fusion_label:
            self.db.increment_emotion_stat(fusion_label)

    HISTORY_PAGE_SIZE = 25

    @login_required
    def history(self, request, session):
        filters = {k: request.args.get(k) or None
                   for k in ('emotion', 'modality', 'start', 'end')}
        try:
            page = max(1, int(request.args.get('page') or 1))
        except ValueError:
            page = 1
        total = self.db.count_user_predictions(session['user_id'], **filters)
        pages = max(1, -(-total // self.HISTORY_PAGE_SIZE))
        page = min(page, pages)
        preds = self.db.get_user_predictions(
            session['user_id'], **filters,
            limit=self.HISTORY_PAGE_SIZE,
            offset=(page - 1) * self.HISTORY_PAGE_SIZE)
        # filter querystring for the pagination links (page appended)
        qs = urlencode({k: v for k, v in filters.items() if v})
        return self.render(session, 'history.html', predictions=preds,
                           page=page, pages=pages, total=total,
                           filter_qs=(qs + '&' if qs else ''))

    @login_required
    def export_history_csv(self, request, session):
        preds = self.db.get_user_predictions(session['user_id'])
        out = io.StringIO()
        writer = csv.writer(out)
        writer.writerow(['date', 'modality', 'emotion', 'confidence',
                         'speech_emotion', 'text_emotion', 'image_emotion'])
        for p in preds:
            writer.writerow([
                p.prediction_date, p.input_type, p.predicted_emotion,
                f'{(p.confidence_score or 0):.4f}',
                p.speech_emotion or '', p.text_emotion or '',
                p.image_emotion or ''])
        return Response(out.getvalue(), mimetype='text/csv', headers={
            'Content-Disposition': 'attachment; filename=history.csv'})

    @login_required
    def statistics_page(self, request, session):
        stats = self.db.get_emotion_statistics()
        return self.render(session, 'statistics.html',
                           labels=[s.emotion for s in stats],
                           values=[s.count for s in stats])

    # ------------------------------------------------------------------
    # JSON API
    # ------------------------------------------------------------------
    def api_register(self, request, session):
        if not self.limiter.allow(f'register:{request.remote_addr}',
                                  ratelimit.REGISTER_RULES):
            return jsonify({'error': 'rate limited'}, 429)
        data = request.get_json(silent=True) or {}
        username, email, password = (data.get('username'),
                                     data.get('email'),
                                     data.get('password'))
        if not (username and email and password):
            return jsonify(
                {'error': 'username, email, and password are required'}, 400)
        # same validators as the HTML route — API clients must not be
        # able to bypass the password policy or create unsanitized names
        username = sanitize_text(str(username))
        email = sanitize_text(str(email))
        for ok, msg in (validate_username(username),
                        validate_email(email),
                        validate_password(str(password))):
            if not ok:
                return jsonify({'error': msg}, 400)
        if self.db.find_user(username, email):
            return jsonify({'error': 'username or email exists'}, 409)
        user = self.db.create_user(username, email, password)
        session['user_id'] = user.id
        session['username'] = user.username
        return jsonify({'id': user.id, 'username': user.username,
                        'email': user.email}, 201)

    def api_login(self, request, session):
        if not self.limiter.allow(f'login:{request.remote_addr}',
                                  ratelimit.LOGIN_RULES):
            return jsonify({'error': 'rate limited'}, 429)
        data = request.get_json(silent=True) or {}
        username, password = data.get('username'), data.get('password')
        if not (username and password):
            return jsonify({'error': 'username and password required'}, 400)
        user = self.db.find_user(username)
        if not user or not user.check_password(password):
            return jsonify({'error': 'invalid credentials'}, 401)
        session['user_id'] = user.id
        session['username'] = user.username
        return jsonify({'message': 'logged in', 'username': user.username})

    def api_logout(self, request, session):
        session.clear()
        return jsonify({'message': 'logged out'})

    def api_user_profile(self, request, session):
        if 'user_id' not in session:
            return jsonify({'error': 'unauthorized'}, 401)
        return jsonify({'id': session['user_id'],
                        'username': session.get('username')})

    def api_predict_speech(self, request, session):
        if 'audio' not in request.files:
            return jsonify({'error': 'multipart/form-data with audio file '
                            'required (field name: audio)'}, 400)
        path = self._save_upload(request.files['audio'], 'audio')
        if not path:
            return jsonify({'error': 'invalid file'}, 400)
        result = clean_result(self._submit(self.batcher.speech, path, path))
        self._record(session, 'speech', result, 'speech', path)
        return jsonify(result)

    def api_predict_text(self, request, session):
        data = request.get_json(silent=True) or {}
        text = data.get('text')
        if not text:
            return jsonify({'error': 'text is required'}, 400)
        result = clean_result(self.batcher.text.submit(text))
        self._record(session, 'text', result, 'text')
        return jsonify(result)

    def api_predict_image(self, request, session):
        if 'image' not in request.files:
            return jsonify({'error': 'multipart/form-data with image file '
                            'required (field name: image)'}, 400)
        path = self._save_upload(request.files['image'], 'image')
        if not path:
            return jsonify({'error': 'invalid file'}, 400)
        result = clean_result(self._submit(self.batcher.image, path, path))
        self._record(session, 'image', result, 'image', path)
        return jsonify(result)

    def api_predict_multimodal(self, request, session):
        text = request.form.get('text') or \
            (request.get_json(silent=True) or {}).get('text')
        audio_path = self._save_upload(request.files.get('audio'), 'audio')
        image_path = self._save_upload(request.files.get('image'), 'image')
        payload = self._multimodal_payload(audio_path, text, image_path)
        results = self._submit(self.batcher.multimodal, payload,
                               audio_path, image_path)
        self._save_multimodal(session, results)
        return jsonify({k: clean_result(v) for k, v in results.items()})

    @api_login_required
    def api_predictions(self, request, session):
        preds = self.db.get_user_predictions(session['user_id'])
        return jsonify([{'id': p.id, 'date': p.prediction_date,
                         'modality': p.input_type,
                         'emotion': p.predicted_emotion,
                         'confidence': p.confidence_score}
                        for p in preds])

    @api_login_required
    def api_delete_prediction(self, request, session, pid: int):
        p = self.db.get_prediction(pid)
        if not p or p.user_id != session['user_id']:
            return jsonify({'error': 'not found'}, 404)
        self.db.delete_prediction(pid)
        return jsonify({'message': 'deleted'})

    def api_statistics(self, request, session):
        stats = self.db.get_emotion_statistics()
        return jsonify([{'emotion': s.emotion, 'count': s.count}
                        for s in stats])

    @api_login_required
    def api_metrics(self, request, session):
        """Serving-loop stage timings (new; the reference has no tracing,
        SURVEY.md §5): each stage's percentiles over its last 4,096 calls
        ('stages') and its count and summed ms over every call ('totals');
        + trained-model metrics from the DB."""
        return jsonify({
            'stages': timer.summary(),
            'totals': timer.totals(),
            'batcher': (self._batcher.stats() if self._batcher else {}),
            'models': [{'model': m.model_name, 'accuracy': m.accuracy,
                        'f1': m.f1_score, 'date': m.training_date}
                       for m in self.db.get_model_metrics()],
        })

    @api_login_required
    def api_metrics_stream(self, request, session):
        """Server-Sent Events stream of the live serving metrics
        (stage timers + batcher coalescing stats; additive — the
        reference has no live observability, SURVEY.md §5). Bounded to
        `ticks` frames (default 60, cap 600) so an abandoned browser tab
        cannot pin a worker thread forever; clients reconnect — that is
        SSE's native model. Login-gated and capped at a few concurrent
        streams per process: each open stream pins a WSGI worker thread,
        so anonymous clients must not be able to open them at all, and
        even authenticated ones must not exhaust the thread pool."""
        import math
        import time as _time
        if not self._stream_slots.acquire(blocking=False):
            return jsonify({'error': 'too many concurrent metric streams'},
                           429)
        try:
            ticks = max(1, min(int(request.args.get('ticks', '60')), 600))
        except ValueError:
            ticks = 60
        try:
            interval = float(request.args.get('interval', '1'))
        except ValueError:
            interval = 1.0
        if not math.isfinite(interval):  # NaN passes through min/max
            interval = 1.0
        interval = min(max(interval, 0.2), 30.0)
        # bound the TOTAL stream duration, not just the factors — one
        # request must not pin a worker thread for ticks*interval hours
        ticks = min(ticks, max(1, int(120.0 / interval)))

        def frames():
            for i in range(ticks):
                payload = json.dumps({
                    'ts': _time.time(),
                    'stages': timer.summary(),
                    'totals': timer.totals(),
                    'batcher': (self._batcher.stats()
                                if self._batcher else {}),
                })
                yield f'data: {payload}\n\n'
                if i + 1 < ticks:
                    _time.sleep(interval)

        resp = Response(frames(), mimetype='text/event-stream',
                        headers={'Cache-Control': 'no-cache',
                                 'X-Accel-Buffering': 'no'})
        # release on response close — fires on normal exhaustion, client
        # disconnect, AND if the WSGI server never iterates the body
        # (a generator finally would miss that last case)
        resp.call_on_close(self._stream_slots.release)
        return resp


def create_app(db=None, engine=None, testing: bool = False,
               models_dir: Optional[str] = None,
               device='cuda') -> EmotionApp:
    """The WSGI app; without an engine it builds get_engine(models_dir,
    device=device) at the first request that needs one."""
    if not testing and Config.SECRET_KEY == 'change-this-secret-key':
        # sessions are HMAC-signed with this key; the default is public
        # (it is the reference's default too, reference config.py) and
        # lets anyone forge an authenticated cookie
        logging.getLogger('mec_tpu_torch.webapp').warning(
            'SECRET_KEY is the public default — set the SECRET_KEY env '
            'var in production or session cookies are forgeable')
    return EmotionApp(db=db, engine=engine, testing=testing,
                      models_dir=models_dir, device=device)
