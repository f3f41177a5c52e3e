"""The port's web app (mec_tpu_torch/webapp/) against the JAX package's:
one list of requests through each, over its own engine on the same tiny
models directory (written by the port's writer, which takes a second
where the JAX one takes most of a minute), and the answers, statuses
and database rows compared; the copied host modules pinned to their
originals; the serve CLI's flags; the trainers' model_metrics write.

Tolerances, each with its reason:

* statuses, JSON answers other than probabilities, database rows
  (without ids, timestamps, salted password hashes and the uploads'
  random prefixes), HTML pages (without their random CSRF tokens):
  equal;
* probabilities and confidences: 1e-4, the fp32 parity contract (both
  engines in fp32 on the CPU), with decisions equal.
"""

import io
import os
import re
import sqlite3

import numpy as np
import pytest
import torch
from PIL import Image
from werkzeug.test import Client

from mec_tpu.config import Config as JaxConfig
from mec_tpu.database import Database as JaxDatabase
from mec_tpu.database import db as jdb
from mec_tpu.serving.engine import EmotionEngine as JaxEngine
from mec_tpu.training import common as jcommon
from mec_tpu.webapp import app as japp
from mec_tpu_torch.config import Config
from mec_tpu_torch.database import Database
from mec_tpu_torch.database import db as tdb
from mec_tpu_torch.ops import wav
from mec_tpu_torch.serving.engine import EmotionEngine
from mec_tpu_torch.serving.synthetic_artifacts import \
    write_synthetic_artifacts
from mec_tpu_torch.training import common, train_speech
from mec_tpu_torch.webapp import app as tapp
from mec_tpu_torch.webapp import serve

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROB_ATOL = 1e-4
USER = {'username': 'webuser', 'email': 'web@example.com',
        'password': 'password123'}


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    """The tier-1 run has six workers on the CPU: torch's default of one
    thread a core in each of them makes them spin on each other, so this
    file keeps torch at two threads and restores the count afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _wav_bytes(tmp, i):
    t = np.arange(66150) / 22050.0
    y = (0.1 + 0.1 * i) * np.sin(2 * np.pi * (220 + 170 * i) * t)
    path = os.path.join(tmp, f'clip{i}.wav')
    wav.write_wav(path, y.astype(np.float32), 22050)
    with open(path, 'rb') as f:
        return f.read()


def _png_bytes(i):
    buf = io.BytesIO()
    rng = np.random.RandomState(10 + i)
    Image.fromarray(rng.randint(0, 256, (40, 48, 3), np.uint8)).save(
        buf, format='PNG')
    return buf.getvalue()


def script(tmp):
    """The requests, as (method, path, keyword arguments of the test
    client's open) built fresh for each app (file objects are read)."""
    w0, w1 = _wav_bytes(tmp, 0), _wav_bytes(tmp, 1)
    p0, p1 = _png_bytes(0), _png_bytes(1)
    return [
        ('GET', '/', {}),
        ('GET', '/login', {}),
        ('GET', '/no/such/page', {}),
        ('GET', '/api/no/such/route', {}),
        ('GET', '/api/predictions', {}),                     # 401
        ('POST', '/api/register', {'json': USER}),
        ('POST', '/api/register', {'json': USER}),           # 409
        ('POST', '/api/register', {'json': {**USER, 'username': 'x'}}),
        ('POST', '/api/logout', {}),
        ('POST', '/api/login', {'json': {'username': USER['username'],
                                         'password': 'wrong-password'}}),
        ('POST', '/api/login', {'json': {'username': USER['username'],
                                         'password': USER['password']}}),
        ('GET', '/api/user/profile', {}),
        ('POST', '/api/predict/text', {'json': {'text': 'i am so happy'}}),
        ('POST', '/api/predict/text', {'json': {}}),         # 400
        ('POST', '/api/predict/speech',
         {'data': {'audio': (io.BytesIO(w0), 'clip.wav')}}),
        ('POST', '/api/predict/speech',
         {'data': {'audio': (io.BytesIO(b'nope'), 'evil.exe')}}),
        ('POST', '/api/predict/image',
         {'data': {'image': (io.BytesIO(p0), 'face.png')}}),
        ('POST', '/api/predict/multimodal',
         {'data': {'text': 'this is terrible and sad',
                   'audio': (io.BytesIO(w1), 'clip.wav'),
                   'image': (io.BytesIO(p1), 'face.png')}}),
        ('POST', '/api/predict/multimodal',
         {'data': {'text': 'wow what a surprise',
                   'audio': (io.BytesIO(w0), 'clip.wav')}}),
        ('POST', '/api/predict/speech',
         {'data': {'audio': (io.BytesIO(b'0' * (17 * 1024 * 1024)),
                             'big.wav')}}),                  # 413
        ('GET', '/api/predictions', {}),
        ('GET', '/api/statistics', {}),
        ('GET', '/history/export.csv', {}),
        ('GET', '/history', {}),
        ('GET', '/dashboard', {}),
        ('GET', '/statistics', {}),
        ('DELETE', '/api/predictions/1', {}),
        ('DELETE', '/api/predictions/999', {}),              # 404
        ('GET', '/api/predictions', {}),
        ('GET', '/static/style.css', {}),
    ]


def drive(module, engine, tmp):
    """The script through one package's app on a fresh database; returns
    (answers, database tables)."""
    db_path = os.path.join(tmp, 'web.db')
    db = (JaxDatabase if module is japp else Database)(db_path)
    app = module.create_app(db=db, engine=engine, testing=True)
    client = Client(app)
    answers = []
    try:
        for method, path, kw in script(tmp):
            r = client.open(path, method=method, **kw)
            answers.append((method, path, r.status_code,
                            r.headers.get('Content-Type'), r.get_data()))
    finally:
        if app._batcher is not None:
            app._batcher.stop()
    con = sqlite3.connect(db_path)
    con.row_factory = sqlite3.Row
    tables = {t: [dict(row) for row in con.execute(
        f'SELECT * FROM {t} ORDER BY id')]
        for t in ('users', 'predictions', 'emotion_statistics',
                  'model_metrics')}
    con.close()
    return answers, tables


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    models = str(tmp_path_factory.mktemp('models'))
    write_synthetic_artifacts(models, tiny=True, image_size=32)
    saved = (JaxConfig.UPLOAD_FOLDER, JaxConfig.LOG_DIR,
             JaxConfig.COMPUTE_DTYPE, Config.UPLOAD_FOLDER, Config.LOG_DIR)
    out = {}
    try:
        JaxConfig.COMPUTE_DTYPE = 'float32'
        jax_engine = JaxEngine(models_dir=models, mesh=None)
        port_engine = EmotionEngine.from_models_dir(
            models, compute_dtype='float32', device='cpu')
        for name, module, engine in (('jax', japp, jax_engine),
                                     ('port', tapp, port_engine)):
            tmp = str(tmp_path_factory.mktemp(name))
            cfg = JaxConfig if name == 'jax' else Config
            cfg.UPLOAD_FOLDER = os.path.join(tmp, 'uploads')
            cfg.LOG_DIR = os.path.join(tmp, 'logs')
            out[name] = drive(module, engine, tmp)
    finally:
        (JaxConfig.UPLOAD_FOLDER, JaxConfig.LOG_DIR, JaxConfig.COMPUTE_DTYPE,
         Config.UPLOAD_FOLDER, Config.LOG_DIR) = saved
    return out


def _same_json(got, want, where):
    """Equal, but probabilities and confidences within PROB_ATOL and
    ids and dates skipped."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            if k in ('id', 'date'):
                continue
            _same_json(got[k], want[k], f'{where}/{k}')
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same_json(g, w, f'{where}[{i}]')
    elif isinstance(want, float):
        assert abs(got - want) <= PROB_ATOL, (where, got, want)
    else:
        assert got == want, where


def _normalise_text(body):
    text = body.decode('utf-8')
    text = re.sub(r'[0-9a-f]{32}', '<token>', text)
    return re.sub(r'\d{4}-\d\d-\d\d \d\d:\d\d:\d\d', '<date>', text)


@pytest.mark.parametrize('i', range(30))
def test_request_answers_like_the_jax_app(runs, i):
    jm, jp, j_status, j_type, j_body = runs['jax'][0][i]
    pm, pp, p_status, p_type, p_body = runs['port'][0][i]
    where = f'{jm} {jp}'
    assert (pm, pp, p_status, p_type) == (jm, jp, j_status, j_type), where
    if j_type.startswith('application/json'):
        import json
        _same_json(json.loads(p_body), json.loads(j_body), where)
    elif j_type.startswith('text/csv'):
        got = _normalise_text(p_body).splitlines()
        want = _normalise_text(j_body).splitlines()
        assert [ln.split(',')[1:3] + ln.split(',')[4:] for ln in got] == \
            [ln.split(',')[1:3] + ln.split(',')[4:] for ln in want], where
        for g, w in zip(got[1:], want[1:]):
            assert abs(float(g.split(',')[3]) - float(w.split(',')[3])) \
                <= PROB_ATOL, where
    else:
        assert _normalise_text(p_body) == _normalise_text(j_body), where


def test_the_script_exercises_every_route_kind(runs):
    assert len(runs['port'][0]) == len(runs['jax'][0]) == 30
    statuses = [a[2] for a in runs['port'][0]]
    assert {200, 201, 400, 401, 404, 409, 413} <= set(statuses)
    predicted = [a for a in runs['port'][0] if a[1].startswith(
        '/api/predict/') and a[2] == 200]
    assert len(predicted) == 5


@pytest.mark.parametrize('table', ['users', 'predictions',
                                   'emotion_statistics', 'model_metrics'])
def test_database_rows_like_the_jax_app(runs, table):
    skip = {'id', 'created_at', 'password_hash', 'prediction_date',
            'last_updated', 'training_date'}
    got, want = runs['port'][1][table], runs['jax'][1][table]
    assert len(got) == len(want)
    if table == 'predictions':
        assert len(got) == 4        # 5 predictions, one deleted
    for g, w in zip(got, want):
        for k in w:
            if k in skip:
                continue
            if k == 'file_path' and w[k]:
                # a random 12-hex prefix keeps concurrent uploads apart
                assert re.sub(r'^.*/[0-9a-f]{12}_', '', g[k]) == \
                    re.sub(r'^.*/[0-9a-f]{12}_', '', w[k])
            elif isinstance(w[k], float):
                assert abs(g[k] - w[k]) <= PROB_ATOL, (table, k)
            else:
                assert g[k] == w[k], (table, k)


@pytest.mark.parametrize('kind', ['csrf', 'rate_limit'])
def test_production_app_refuses_like_the_jax_app(tmp_path, monkeypatch,
                                                 kind):
    """testing=False: an HTML form POST without its CSRF token is 400, and
    the fourth registration from one address within the hour is 429."""
    got = {}
    for name, module, cfg, db_cls in (('jax', japp, JaxConfig, JaxDatabase),
                                      ('port', tapp, Config, Database)):
        monkeypatch.setattr(cfg, 'UPLOAD_FOLDER', str(tmp_path / name))
        monkeypatch.setattr(cfg, 'LOG_DIR', str(tmp_path / 'logs'))
        app = module.create_app(db=db_cls(str(tmp_path / f'{name}.db')),
                                engine=object(), testing=False)
        c = Client(app)
        if kind == 'csrf':
            c.get('/login')
            got[name] = [c.post('/login', data={
                'username': 'u', 'password': 'p'}).status_code]
        else:
            got[name] = [c.post('/api/register', json={
                'username': f'user{i}', 'email': f'u{i}@example.com',
                'password': 'password123'}).status_code for i in range(4)]
    assert got['port'] == got['jax'] == ([400] if kind == 'csrf'
                                         else [201, 201, 201, 429])


def test_one_database_serves_both_front_doors(tmp_path, monkeypatch):
    """A user registered through the JAX app logs in through the port's
    on the same database file, and sees the history written there."""
    monkeypatch.setattr(JaxConfig, 'UPLOAD_FOLDER', str(tmp_path / 'up'))
    monkeypatch.setattr(Config, 'UPLOAD_FOLDER', str(tmp_path / 'up'))
    monkeypatch.setattr(JaxConfig, 'LOG_DIR', str(tmp_path / 'logs'))
    monkeypatch.setattr(Config, 'LOG_DIR', str(tmp_path / 'logs'))
    path = str(tmp_path / 'shared.db')
    jc = Client(japp.create_app(db=JaxDatabase(path), engine=object(),
                                testing=True))
    assert jc.post('/api/register', json=USER).status_code == 201
    JaxDatabase(path).save_prediction(1, input_type='text',
                                      predicted_emotion='happy',
                                      confidence_score=0.9)
    pc = Client(tapp.create_app(db=Database(path), engine=object(),
                                testing=True))
    assert pc.post('/api/login', json={
        'username': USER['username'],
        'password': USER['password']}).status_code == 200
    rows = pc.get('/api/predictions').json
    assert [(r['modality'], r['emotion']) for r in rows] == [('text',
                                                              'happy')]


# ----------------------------------------------------------------------
# the copies, the CLI, the metrics write
# ----------------------------------------------------------------------

def _body(path):
    """A module's code without its docstring, with the port's package
    name read as the JAX package's."""
    with open(os.path.join(_REPO, path), encoding='utf-8') as f:
        src = f.read()
    return src.split('"""', 2)[2].replace('mec_tpu_torch', 'mec_tpu')


@pytest.mark.parametrize('path', ['webapp/sessions.py', 'webapp/ratelimit.py',
                                  'utils/security.py', 'database/db.py'])
def test_copy_matches_original(path):
    assert _body(f'mec_tpu_torch/{path}') == _body(f'mec_tpu/{path}')


def test_serve_cli_parses_the_jax_flags():
    with open(os.path.join(_REPO, 'mec_tpu/webapp/serve.py')) as f:
        jax_flags = re.findall(r"add_argument\('(--[a-z-]+)'", f.read())
    assert jax_flags == ['--host', '--port', '--models-dir', '--warmup',
                         '--threads']
    args = serve.parse_args(['--host', '127.0.0.1', '--port', '5123',
                             '--models-dir', 'm', '--warmup',
                             '--threads', '4'])
    assert (args.host, args.port, args.models_dir, args.warmup,
            args.threads, args.device) == ('127.0.0.1', 5123, 'm', True, 4,
                                           'cuda')
    assert serve.parse_args(['--device', 'cpu']).device == 'cpu'
    defaults = serve.parse_args([])
    assert (defaults.host, defaults.port, defaults.models_dir,
            defaults.warmup) == ('0.0.0.0', 5000, None, False)


@pytest.fixture()
def databases(tmp_path, monkeypatch):
    """Each package's get_db() singleton on a fresh file."""
    dbs = {'jax': JaxDatabase(str(tmp_path / 'jax.db')),
           'port': Database(str(tmp_path / 'port.db'))}
    monkeypatch.setattr(jdb, '_db', dbs['jax'])
    monkeypatch.setattr(tdb, '_db', dbs['port'])
    return dbs


def _metrics(db):
    return [(m.model_name, m.accuracy, m.precision_score, m.recall_score,
             m.f1_score) for m in db.get_model_metrics()]


def test_record_metrics_writes_the_jax_row(databases):
    y_true = np.array([0, 1, 2, 2, 3, 4, 5, 6, 6, 1])
    y_pred = np.array([0, 1, 2, 1, 3, 4, 5, 6, 0, 1])
    for rec in (jcommon.record_metrics, common.record_metrics):
        rec('speech_dnn', 0.8, y_true, y_pred)
        rec('fusion_rf', 0.5)
    assert _metrics(databases['port']) == _metrics(databases['jax'])
    assert len(_metrics(databases['port'])) == 2


def test_trainer_writes_its_model_metrics_row(databases, tmp_path):
    rng = np.random.RandomState(0)
    y = np.repeat(np.arange(7), 6).astype(np.int32)
    X = (rng.randn(len(y), 56) + y[:, None]).astype(np.float32)
    _vars, _scaler, history = train_speech.train(
        X=X, y=y, epochs=2, batch_size=8, models_dir=str(tmp_path / 'm'),
        device='cpu', verbose=False)
    rows = _metrics(databases['port'])
    assert len(rows) == 1 and rows[0][0] == 'speech_dnn'
    assert rows[0][1] == max(history['val_acc'])
    assert all(v is not None for v in rows[0][2:])


def test_metrics_report_totals_past_the_reservoir(tmp_path):
    """/api/metrics and its stream carry timer.totals() under 'totals'
    beside 'stages': every call's count, where a stage's percentiles
    keep its last 4,096."""
    import json
    from mec_tpu_torch.utils.profiling import timer
    app = tapp.create_app(db=Database(str(tmp_path / 'm.db')),
                          engine=EmotionEngine(device='cpu'), testing=True)
    client = Client(app)
    assert client.get('/api/metrics').status_code == 401
    assert client.post('/api/register', json=USER).status_code in (200, 201)
    timer.reset()
    try:
        for _ in range(5000):
            timer.record('batcher.multimodal.queue_wait_ms', 2.0)
        body = client.get('/api/metrics').json
        assert body['stages']['batcher.multimodal.queue_wait_ms'][
            'count'] == 4096
        assert body['totals']['batcher.multimodal.queue_wait_ms'] == {
            'count': 5000, 'sum_ms': 10000.0}
        frames = [f for f in client.get(
            '/api/metrics/stream?ticks=1&interval=0.2').get_data(
                as_text=True).split('\n\n') if f.strip()]
        payload = json.loads(frames[0][len('data: '):])
        assert payload['totals']['batcher.multimodal.queue_wait_ms'][
            'count'] == 5000
        # the app's own endpoint spans count too
        assert payload['totals']['api_metrics']['count'] == 1
    finally:
        timer.reset()
        if app._batcher is not None:
            app._batcher.stop()
