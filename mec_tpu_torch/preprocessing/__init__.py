"""Reference-compatible preprocessing facade: the port of
mec_tpu/preprocessing/.

The reference's import paths, names and results, so user code written
against its `preprocessing` package runs on the port unchanged:

    from mec_tpu_torch.preprocessing.audio_preprocessing import preprocess_audio
    from mec_tpu_torch.preprocessing.text_preprocessing import TextPreprocessor
    from mec_tpu_torch.preprocessing.image_preprocessing import preprocess_image

The audio functions run the port's fp32 parity frontend
(ops/audio_features.py) on the device given (default 'cuda', which
launches the tuning selection kernel K2 there).
"""
