"""One-shot conversion of reference artifacts to the native format.

`python -m mec_tpu_torch convert [--models-dir models]`
(or `python -m mec_tpu_torch.convert`)

A copy of mec_tpu/convert/__main__.py (importing mec_tpu imports jax),
writing the same files through the port's convert/store.py: whatever
reference-format artifacts exist in the directory — speech_model.h5
(+speech_scaler.pkl), text_model.h5 (+text_model_tokenizer.pkl),
image_model.pt (ResNet50 or MobileNetV2, auto-detected),
fusion_model.pt, fusion_rf.pkl (sklearn random forest), bert_model/ —
become the `.mecp` files (and speech_scaler.npz,
text_model_tokenizer.json) the serving engine loads directly. The
engine also does this at its first load (serving/engine.py); the CLI
makes the migration explicit and reports what it found. The .h5 files
need h5py, the .pkl files joblib and sklearn.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from mec_tpu_torch.config import Config
from mec_tpu_torch.convert import store


def convert_all(models_dir: str) -> int:
    converted = 0

    def out(name):
        return os.path.join(models_dir, name)

    # speech
    h5 = out('speech_model.h5')
    if os.path.exists(h5):
        from mec_tpu_torch.convert.keras_h5 import (convert_speech_h5,
                                                    load_sklearn_scaler)
        store.save_params(out('speech_model.mecp'), convert_speech_h5(h5))
        print(f'converted {h5}')
        converted += 1
        pkl = out('speech_scaler.pkl')
        if os.path.exists(pkl):
            mean, scale = load_sklearn_scaler(pkl)
            np.savez(out('speech_scaler.npz'), mean=mean, scale=scale)
            print(f'converted {pkl}')

    # Bi-LSTM text
    h5 = out('text_model.h5')
    if os.path.exists(h5):
        from mec_tpu_torch.convert.keras_h5 import convert_lstm_text_h5
        store.save_params(out('text_model.mecp'), convert_lstm_text_h5(h5))
        print(f'converted {h5}')
        converted += 1
        pkl = out('text_model_tokenizer.pkl')
        if os.path.exists(pkl):
            from mec_tpu_torch.text.keras_tokenizer import KerasTokenizer
            KerasTokenizer.from_keras_pickle(pkl).to_json_file(
                out('text_model_tokenizer.json'))
            print(f'converted {pkl}')

    # image
    pt = out('image_model.pt')
    if os.path.exists(pt):
        from mec_tpu_torch.convert.torch_pt import convert_image_pt
        store.save_params(out('image_model.mecp'), convert_image_pt(pt))
        print(f'converted {pt}')
        converted += 1

    # fusion
    pt = out('fusion_model.pt')
    if os.path.exists(pt):
        from mec_tpu_torch.convert.torch_pt import (convert_fusion_pt,
                                                    fusion_config_from_pt)
        store.save_params(out('fusion_model.mecp'), convert_fusion_pt(pt),
                          meta={'config': fusion_config_from_pt(pt)})
        print(f'converted {pt}')
        converted += 1

    # random-forest fusion variant (sklearn joblib/pickle)
    pkl = out('fusion_rf.pkl')
    if os.path.exists(pkl):
        from mec_tpu_torch.convert.sklearn_rf import convert_fusion_rf
        variables, meta = convert_fusion_rf(pkl)
        store.save_params(out('fusion_rf.mecp'), variables, meta=meta)
        print(f'converted {pkl}')
        converted += 1

    # BERT dir
    bert_dir = out('bert_model')
    if os.path.isdir(bert_dir) and not os.path.exists(
            os.path.join(bert_dir, 'bert_model.mecp')):
        from mec_tpu_torch.convert.hf_bert import convert_bert_dir
        store.save_params(os.path.join(bert_dir, 'bert_model.mecp'),
                          convert_bert_dir(bert_dir))
        print(f'converted {bert_dir}')
        converted += 1

    if not converted:
        print(f'no reference artifacts found under {models_dir}')
    return converted


def main(argv=None):
    p = argparse.ArgumentParser(
        description='Convert reference checkpoints to native .mecp')
    p.add_argument('--models-dir',
                   default=os.path.dirname(Config.SPEECH_MODEL_PATH)
                   or 'models')
    args = p.parse_args(argv)
    convert_all(args.models_dir)


if __name__ == '__main__':
    main()
