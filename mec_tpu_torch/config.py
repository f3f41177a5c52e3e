"""The subset of mec_tpu.config.Config that the ported serving slices read.

Same attribute names, same defaults, same MEC_* environment variables as
mec_tpu/config.py (which cannot be imported here: importing any mec_tpu
module imports jax). tests/test_torch_engine.py pins every value below
against the original.
"""

import os


def _env_flag(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


class Config:
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

    # Compute dtype: 'bfloat16' is the serving mode (BN folded into the
    # convs, int8 bottleneck convs, YUV wire); 'float32' is the parity
    # mode (live BN, fp32 convs, logits within 1e-4 of the reference).
    COMPUTE_DTYPE = os.environ.get('MEC_COMPUTE_DTYPE', 'float32')

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
