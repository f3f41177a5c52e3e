"""Training for the port: the six trainers of mec_tpu/training/.

  train_speech      the speech DNN on a wav tree (features from the
                    device's parity frontend)
  train_text_lstm   the Bi-LSTM text model
  train_text_bert   BERT fine-tuning
  train_image       ResNet50 / MobileNetV2, two phases
  train_fusion      the attention fusion net (synthetic or real triples)
  train_fusion_rf   the random-forest fusion (needs sklearn)

Each writes the JAX trainer's artifacts (same file names, Flax trees,
meta keys) through convert/store.py, so either package's engine serves
the directory. common.py holds the optimizers, the train state and the
fit loop, checkpoint.py resume, data.py the loaders, corpora.py the
synthetic corpora of the end-to-end walkthrough, metrics.py the numpy
metrics.
"""
