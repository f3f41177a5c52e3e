"""mec_tpu_torch — the PyTorch/CUDA port of mec_tpu, for NVIDIA Hopper.

The JAX package `mec_tpu` stays beside this one as the reference; every
module here mirrors the path of its `mec_tpu` counterpart and is held
against it by the tests in tests/test_torch_*.py. This package imports
torch and never jax, nor any module of mec_tpu (importing one imports
jax, and the machine that runs the port on the card has no flax), so
the host modules it needs (config with its .env loader, filters, wav,
the batcher, fold, quant, image preprocessing, text cleaning, the
WordPiece and Keras tokenizers, the training metrics, loaders and
corpora, the checkpoint converters, the web app, the database and the
security helpers) are copies pinned to their originals by tests.

What is ported so far:

* the speech serving path: waveform -> wire (12-bit PCM in bf16
  serving mode, float32 in fp32 parity mode) -> on-device 56-dim
  frontend (hop-slab, or with MEC_DFT_PRECISION=highest|bf16 in bf16 the
  framed one on the DFT kernel) -> full-width speech DNN -> result dicts;
* the text path: WordPiece ids -> BERT-base (bf16 serving: int8 static
  encoder matmuls, tanh GELU; fp32 parity: erf GELU), sliced to a
  sequence bucket -> result dicts;
* the image serving path: uint8 RGB -> YUV 4:2:0 wire -> on-device
  decode and normalize -> ResNet50 -> result dicts, in bf16 serving mode
  (BN folded, int8 bottleneck convs with static scales) and in fp32
  parity mode (live BN);
* the attention fusion and the tri-modal request: the three encoders
  and the fusion net in one device step -> one packed row per request;
  with MEC_FUSION_MODE=rf the random-forest fusion (a level-synchronous
  walk over the three softmax outputs) in its place;
* MobileNetV2 as the image model, in the same three forms as ResNet50;
* a models directory of the JAX package's .mecp artifacts, read and
  written without flax or msgpack, served through get_engine and the
  reference-API facades (inference/), the Bi-LSTM text model included;
* training: the six trainers (speech, Bi-LSTM, BERT, ResNet50 /
  MobileNetV2, attention fusion, random-forest fusion) over one fit
  loop with optax's optimizers, Flax's BatchNorm update and resumable
  checkpoints, writing the JAX trainers' artifacts; `python -m
  mec_tpu_torch train-...`;
* the mixture-of-experts BERT (models/moe.py), served from a models
  directory and trained with --experts;
* data-parallel training over torch.distributed (--mesh-data N: one
  process a device, parallel/), and the BERT trainer's tensor,
  sequence, expert and pipeline axes;
* the reference's own artifacts (Keras .h5, torch .pt, sklearn .pkl,
  HF BERT directories) converted at load or by `python -m mec_tpu_torch
  convert`, and the web service: `python -m mec_tpu_torch serve`;
* the native host runtime (native/: C++ wire encoders, WordPiece and
  the host audio featurizer) and the preprocessing facade;
* the measuring tools (utils/roofline.py: H100 peaks, CUDA-graph chain
  timers, the measured memory rate, a traffic model; device_trace; the
  engine's batch-1 phase clock) and the dataset commands (datasets/:
  `python -m mec_tpu_torch download|organize`).

With these the port does what mec_tpu does; what it leaves out on
purpose (the TPU's workarounds) is listed in ROADMAP.md.

All seven TPU Pallas kernels are rewritten as CUDA C++ kernels for
sm_90a (csrc/, built at first use by ops/_build.py): K1 mfcc_mean, K2
tuning_select, K3 rolloff_bins, K4 speech_dnn, K5 dft_power (the framed
DFT), K6 the stem max-pool, K7 the int8 layer1.

Package layout:
  config.py   mec_tpu.config's keys that the port reads, load_dotenv
  ops/        frontend (audio_features), kernel wrappers + plain twins,
              numpy filter tables, WAV decode, BN fold, int8 quantization,
              the nvcc build
  csrc/       the hand-written CUDA kernels
  models/     SpeechDNN, the Bi-LSTM, BERT (and its MoE FFN), ResNet50,
              MobileNetV2, the fusion net, the forest walk, QuantConv and
              QuantDense (plain nn.Modules and torch ops; built in eval
              mode, with training forwards), Flax's BatchNorm step and
              remat
  image/      image decode and the ImageNet constants
  text/       text cleaning, the WordPiece and Keras tokenizers
  convert/    the .mecp reader and writer, the HF config.json widths,
              JAX (Flax numpy tree) <-> port parameters, the reference
              checkpoint converters (Keras .h5, torch .pt, HF BERT,
              sklearn forest) and convert_all
  training/   the fit loop, optimizers, checkpoints, loaders, synthetic
              corpora and the six trainers
  parallel/   the data axis: process-group init, DataMesh, the rank
              launcher
  serving/    wire codecs, engine (and get_engine), micro-batcher,
              synthetic parameters and models directories
  inference/  the reference-API facades over get_engine
  webapp/     the WSGI app (werkzeug; jinja2 for the HTML pages), its
              sessions, rate limiter and serve CLI
  database/   sqlite3 (or PyMySQL) users, predictions, statistics and
              model metrics
  utils/      StageTimer, device_trace, the roofline helpers,
              rotating-file logging, input validation
  datasets/   the Kaggle download and the raw-dataset organizers
  native/     the C++ host libraries (g++ at first use) and their
              bindings
  preprocessing/  the reference's preprocessing facade
  __main__    python -m mec_tpu_torch: the train commands, serve,
              convert, download, organize
"""

import torch

__version__ = "0.1.0"

# The parity contract with the JAX fp32 reference is 1e-4 on features
# and probabilities; TF32 keeps about 3 decimal digits, so fp32 matmuls
# and convolutions must run in full fp32. The matmul flag already
# defaults to False, cuDNN's does not; both are set so the policy is
# explicit.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
