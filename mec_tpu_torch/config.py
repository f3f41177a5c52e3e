"""The port's configuration: mec_tpu.config.Config's keys that the port
reads, and its .env loader.

Same attribute names, same defaults, same environment variables as
mec_tpu/config.py (which cannot be imported here: importing any mec_tpu
module imports jax). tests/test_torch_engine.py and
tests/test_torch_config.py pin every value below, and load_dotenv,
against the original. DATABASE_PATH is the JAX package's file, so
either front door serves one deployment's users and history.
"""

import os
import sys
from datetime import timedelta

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_dotenv(path: str = '.env') -> bool:
    """Minimal python-dotenv equivalent, as the reference calls
    `load_dotenv()` before its Config is read (reference app.py:40): a
    `.env` file in the working directory configures the service.
    Existing environment variables win (python-dotenv's default
    override=False). Returns True if a file was loaded."""
    try:
        with open(path, encoding='utf-8') as f:
            lines = f.readlines()
    except OSError:
        return False
    for line in lines:
        line = line.strip()
        if not line or line.startswith('#'):
            continue
        if line.startswith('export '):  # shell-style prefix, as dotenv does
            line = line[len('export '):].lstrip()
        key, sep, value = line.partition('=')
        key, value = key.strip(), value.strip()
        if not sep or not key:
            continue
        if len(value) >= 2 and value[0] == value[-1] and value[0] in '\'"':
            value = value[1:-1]
        else:
            # unquoted values: a whitespace-preceded '#' starts a comment
            for marker in (' #', '\t#'):
                idx = value.find(marker)
                if idx != -1:
                    value = value[:idx].rstrip()
        os.environ.setdefault(key, value)
    return True


# Implicit load at import time, as mec_tpu.config does, but a stray .env
# in the working directory must not silently reconfigure tests or
# benches: pytest runs and MEC_SKIP_DOTENV=1 opt out.
if os.environ.get('MEC_SKIP_DOTENV', '').strip().lower() not in (
        '1', 'true', 'yes', 'on') and 'pytest' not in sys.modules:
    load_dotenv()


def _env_flag(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


class Config:
    # Secret key (reference config.py:7): signs the session cookies
    SECRET_KEY = os.environ.get('SECRET_KEY') or 'change-this-secret-key'

    # CSRF protection of the HTML forms (reference config.py:10-11)
    WTF_CSRF_ENABLED = True
    WTF_CSRF_TIME_LIMIT = None

    # HTTPS enforcement in production (reference app.py:77-83)
    FORCE_HTTPS = os.environ.get('FLASK_ENV') == 'production'

    # Session security (reference config.py:14-18)
    SESSION_COOKIE_SECURE = os.environ.get('FLASK_ENV') == 'production'
    SESSION_COOKIE_HTTPONLY = True
    SESSION_COOKIE_SAMESITE = 'Lax'
    PERMANENT_SESSION_LIFETIME = timedelta(hours=24)
    SESSION_REFRESH_EACH_REQUEST = True

    # Security headers (reference config.py:21-26)
    SECURITY_HEADERS = {
        'X-Content-Type-Options': 'nosniff',
        'X-Frame-Options': 'DENY',
        'X-XSS-Protection': '1; mode=block',
        'Strict-Transport-Security': 'max-age=31536000; includeSubDomains',
    }

    # Database (reference config.py:29-35): the JAX package's sqlite file
    # (a path to data, not an import); DATABASE_URL overrides it
    # (database/db.py::make_database)
    DATABASE_PATH = os.path.join(_REPO_ROOT, 'mec_tpu', 'database', 'emotion.db')
    SQLALCHEMY_DATABASE_URI = (
        os.environ.get('DATABASE_URL')
        or f"sqlite:///{DATABASE_PATH}"
    )

    # Upload settings (reference config.py:47-50)
    UPLOAD_FOLDER = os.environ.get('UPLOAD_FOLDER', 'static/uploads')
    MAX_FILE_SIZE = 16 * 1024 * 1024  # 16MB
    ALLOWED_AUDIO_EXTENSIONS = {'wav', 'mp3', 'ogg'}
    ALLOWED_IMAGE_EXTENSIONS = {'png', 'jpg', 'jpeg'}

    # Labels (reference config.py:53-54)
    EMOTIONS = ['happy', 'sad', 'angry', 'fear', 'disgust', 'surprise', 'neutral']
    NUM_EMOTIONS = 7

    # Audio settings (reference config.py:57-59)
    SAMPLE_RATE = 22050
    AUDIO_DURATION = 3
    N_MFCC = 40

    # Number of audio samples per clip after pad/trim
    AUDIO_SAMPLES = SAMPLE_RATE * AUDIO_DURATION  # 66150

    # STFT parameters matching librosa 0.10 defaults
    N_FFT = 2048
    HOP_LENGTH = 512
    N_MELS = 128

    # Serving: micro-batch bucket sizes. Requests are padded up to the
    # smallest bucket >= pending count.
    BATCH_BUCKETS = tuple(
        int(x) for x in os.environ.get('MEC_BATCH_BUCKETS', '1,8,32').split(',')
    )
    # Max time the batcher waits to fill a bucket before flushing (seconds).
    BATCH_TIMEOUT_S = float(os.environ.get('MEC_BATCH_TIMEOUT_S', '0.003'))
    # Adaptive linger cap while new requests keep arriving (seconds).
    BATCH_MAX_LINGER_S = float(
        os.environ.get('MEC_BATCH_MAX_LINGER_S', '0.02'))
    # Load shedding: max requests queued per batch queue; 0 disables.
    BATCH_MAX_PENDING = int(os.environ.get('MEC_BATCH_MAX_PENDING', '256'))
    # Batches in flight per queue (1 = serial).
    BATCH_PIPELINE_DEPTH = int(os.environ.get('MEC_BATCH_PIPELINE', '2'))

    # Compressed host->device wire: packed 12-bit PCM audio with a
    # per-clip scale (serving/wire.py); off ships PCM16, as the JAX
    # engine's serving mode does.
    WIRE_COMPRESS = _env_flag('MEC_WIRE_COMPRESS', True)

    # Text settings (reference config.py:62)
    MAX_TEXT_LENGTH = 128

    # Padded sequence-length buckets for BERT dispatch: a batch is sliced
    # to the smallest bucket covering its longest text. Exact: padded
    # keys carry an additive bias of the f32 minimum, so their attention
    # weight is exactly 0.0.
    SEQ_BUCKETS = tuple(
        int(x) for x in os.environ.get('MEC_SEQ_BUCKETS',
                                       '16,32,128').split(',')
        if x.strip())

    # Serving-mode speech DFT: 'high' (default) is the hop-slab frontend;
    # 'highest' (fp32) and 'bf16' (bf16 operands, fp32 sums) take the
    # framed frontend on kernel K5. bf16 serving mode only: fp32 parity
    # mode always runs the hop-slab frontend in fp32.
    DFT_PRECISION = os.environ.get('MEC_DFT_PRECISION', 'high')

    # Image settings (reference config.py:65)
    IMAGE_SIZE = (224, 224)

    # Rate limiting of the web app (webapp/ratelimit.py: the reference's
    # Flask-Limiter rules; MEC_RATELIMIT_* override them); 0 disables
    RATELIMIT_ENABLED = _env_flag('MEC_RATELIMIT', True)

    # Compute dtype: 'bfloat16' is the serving mode (BN folded into the
    # convs, int8 bottleneck convs, YUV wire); 'float32' is the parity
    # mode (live BN, fp32 convs, logits within 1e-4 of the reference).
    COMPUTE_DTYPE = os.environ.get('MEC_COMPUTE_DTYPE', 'float32')

    # The kernel switches, with the JAX package's scope (its Pallas
    # switches). USE_PALLAS=0 takes the bf16 speech leg off K1, K3, K4
    # and K5: the frontend is the parity graph's (rFFT STFT, MFCC by two
    # matmuls, cumsum rolloff) and the DNN the plain SpeechDNN; K2 stays,
    # as JAX's tuning selection does. PALLAS_TUNING=0 turns off K2 alone
    # (the plain selection runs on the card), PALLAS_ROLLOFF=0 K3 alone
    # (the cumsum rolloff). K6 and K7 have no switch: the JAX main path
    # never calls its pool and layer1 kernels. An operator's choice, not
    # a fallback: a kernel that fails still raises.
    USE_PALLAS = _env_flag('MEC_USE_PALLAS', True)
    PALLAS_TUNING = _env_flag('MEC_PALLAS_TUNING', True)
    PALLAS_ROLLOFF = _env_flag('MEC_PALLAS_ROLLOFF', True)

    # Host audio featurization in bf16, resolved as in JAX
    # (serving/engine.py::_resolve_host_audio): 1/true/yes/on turns it
    # on; 'auto' turns it on with >= 4 CPUs and the C++ featurizer built
    # (native/featurizer.py); fp32 parity mode never uses it.
    HOST_AUDIO_FEATURES = os.environ.get('MEC_HOST_AUDIO_FEATURES', 'auto')

    # bf16 serving: fold image-model BatchNorm into the conv kernels and
    # biases at load (ops/fold.py). fp32 parity mode ignores this.
    FOLD_BN = _env_flag('MEC_FOLD_BN', True)

    # bf16 serving: after the fold, quantize the 52 ResNet50 bottleneck
    # convs to int8 (ops/quant.py, models/qconv.py). fp32 ignores this.
    IMAGE_INT8 = _env_flag('MEC_IMAGE_INT8', True)

    # bf16 serving: quantize the BERT encoder matmuls (q/k/v, attention
    # out, FFN) to int8 (ops/quant.quantize_bert_params,
    # models/qconv.QuantDense). fp32 ignores this.
    BERT_INT8 = _env_flag('MEC_BERT_INT8', True)

    # Static int8 activation scales, calibrated once at engine load
    # (ops/quant.calibrate_static_scales); off = per-example (convs) or
    # per-token (dense) dynamic scales.
    INT8_STATIC = _env_flag('MEC_INT8_STATIC', True)

    # Fusion backend: 'attention' (the attention network) or 'rf' (the
    # random-forest ensemble over the per-modality softmax outputs,
    # models/forest.py), which needs the fusion_rf artifact; without it
    # the engine serves the attention network, as the JAX engine does.
    FUSION_MODE = os.environ.get('MEC_FUSION_MODE', 'attention')

    # Model artifact paths (reference config.py:39-44). The engine reads
    # the .mecp beside each (serving/engine.py::EmotionEngine.
    # from_models_dir); with a models_dir it takes their basenames there.
    SPEECH_MODEL_PATH = os.environ.get('SPEECH_MODEL_PATH', 'models/speech_model.h5')
    SPEECH_SCALER_PATH = os.environ.get('SPEECH_SCALER_PATH', 'models/speech_scaler.pkl')
    TEXT_MODEL_PATH = os.environ.get('TEXT_MODEL_PATH', 'models/text_model.h5')
    IMAGE_MODEL_PATH = os.environ.get('IMAGE_MODEL_PATH', 'models/image_model.h5')
    FUSION_MODEL_PATH = os.environ.get('FUSION_MODEL_PATH', 'models/fusion_model.pkl')
    BERT_MODEL_PATH = os.environ.get('BERT_MODEL_PATH', 'models/bert_model')
    FUSION_RF_MODEL_PATH = os.environ.get('FUSION_RF_MODEL_PATH',
                                          'models/fusion_rf.pkl')

    # Mesh axis sizes (parallel/mesh.local_mesh_shape); 'auto' puts every
    # rank on the data axis. The port has the data axis only.
    MESH_DATA = os.environ.get('MEC_MESH_DATA', 'auto')
    MESH_MODEL = int(os.environ.get('MEC_MESH_MODEL', '1'))

    # Logging (utils/logging_config.py: LOG_DIR/<name>.log)
    LOG_DIR = os.environ.get('MEC_LOG_DIR', 'logs')
