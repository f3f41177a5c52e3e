"""The reference answer to a list of tri-modal requests, composed from the
pieces the configuration names under "reference":

  audio -> speech_features -> (x - mean) / scale -> speech    (probs, feat)
  tokenizer -> text                                            (probs, feat)
  image_decode -> the image wire -> image                      (probs, feat)
  fusion (on the reference's features, or on the program's returned
          modality probabilities where the piece says INPUT = 'program')

Runs in blocks of requests on `device`, in float32 with TF32 off
(`Prec(table, control=False)`), or as the control (`Prec(table)`).
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from benchmark.reference.precision import Prec


EMOTIONS = ('happy', 'sad', 'angry', 'fear', 'disgust', 'surprise',
            'neutral')


def calibration_frames(size: int) -> np.ndarray:
    """(6, size, size, 3) float32 pixels: noise over the full range and over
    96-159 (numpy RandomState(0)), the vertical and horizontal gradients,
    white and black."""
    rng = np.random.RandomState(0)
    ramp = np.linspace(0.0, 255.0, size, dtype=np.float32)
    frames = [rng.randint(0, 256, (size, size, 3)),
              rng.randint(96, 160, (size, size, 3)),
              np.broadcast_to(ramp[:, None, None], (size, size, 3)),
              np.broadcast_to(ramp[None, :, None], (size, size, 3)),
              np.full((size, size, 3), 255.0), np.zeros((size, size, 3))]
    return np.stack(frames).astype(np.float32)


def to_torch(tree, device):
    """numpy float arrays to float32 tensors on `device`; anything else
    (a seeded leaf, a tensor, a number) as it is."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.dtype.kind == 'f':
        return torch.as_tensor(tree, dtype=torch.float32, device=device)
    return tree


class Reference:
    def __init__(self, cfg: Dict, trees: Dict, vocab: Dict[str, int],
                 device, prec: Optional[Prec] = None):
        self.cfg, self.vocab, self.device = cfg, vocab, device
        self.prec = prec or Prec(cfg['precision'], control=False)
        self.mod = {role: importlib.import_module(f'benchmark.reference.{n}')
                    for role, n in cfg['reference'].items()}
        self.trees = {k: to_torch(trees[k], device)
                      for k in ('speech', 'text', 'image', 'fusion')
                      if k in trees}
        self.forest = trees.get('forest')
        sc = cfg['speech_scaler']
        self.mean = torch.tensor(sc['mean'], device=device)
        self.scale = torch.tensor(sc['scale'], device=device)
        if self.prec.needs_calibration():
            self.calibrate()

    @torch.no_grad()
    def calibrate(self) -> None:
        """The static activation ranges of the int4 stages, from the
        calibration inputs the program calibrates its int8 ones on: seven
        keyworded sentences at the full text length, and six frames
        (noise at two contrasts, both gradients, white, black)."""
        m, prec, dev = self.mod, self.prec, self.device
        prec.calibrating = True
        prec.start()
        text = self.cfg['text']
        ids, mask = m['tokenizer'].encode(
            [f'i feel so {e} about all of this today' for e in EMOTIONS],
            self.vocab, text['max_length'])
        m['text'].forward(self.trees['text'], torch.as_tensor(ids, device=dev),
                          torch.as_tensor(mask, device=dev), text, prec)
        size = self.cfg['image']['img_size']
        m['image'].forward(self.trees['image'], m['image_decode'].normalize(
            torch.as_tensor(calibration_frames(size), device=dev)), prec)
        prec.calibrating = False

    @torch.no_grad()
    def block(self, reqs: Sequence, program: Optional[Sequence[Dict]] = None
              ) -> List[Dict[str, np.ndarray]]:
        """reqs: objects with audio_path, text, image_path. program: the
        answers the program returned for them (read by a fusion piece
        whose INPUT is 'program')."""
        m, prec, dev = self.mod, self.prec, self.device
        prec.start()
        waves = torch.as_tensor(np.stack([m['audio'].load(r.audio_path)
                                          for r in reqs]), device=dev)
        waves = prec.wave(waves, 'audio_wire')
        feats = m['speech_features'].features(waves, prec)
        feats = prec.values(feats, 'speech_wire')
        s_p, s_f = m['speech'].forward(self.trees['speech'],
                                       (feats - self.mean) / self.scale,
                                       prec)
        text = self.cfg['text']
        ids, mask = m['tokenizer'].encode([r.text for r in reqs], self.vocab,
                                          text['max_length'])
        L = int(mask.sum(1).max())
        t_p, t_f = m['text'].forward(
            self.trees['text'], torch.as_tensor(ids[:, :L], device=dev),
            torch.as_tensor(mask[:, :L], device=dev), text, prec)
        size = self.cfg['image']['img_size']
        u8 = torch.as_tensor(np.stack([m['image_decode'].load(r.image_path,
                                                              size)
                                       for r in reqs]), device=dev)
        i_p, i_f = m['image'].forward(
            self.trees['image'], m['image_decode'].normalize(
                m['image_decode'].wire(u8, prec.image_wire)), prec)
        fusion = m['fusion']
        if fusion.INPUT == 'program':
            # the program's returned modality probabilities; without
            # them (the control in the program's place) its own
            probs = (tuple(torch.tensor([a[k]['all_probabilities']
                                         for a in program],
                                        dtype=torch.float32)
                           for k in ('speech', 'text', 'image'))
                     if program is not None else (s_p, t_p, i_p))
            f_p = fusion.forward(self.forest, probs, prec)
        else:
            f_p = fusion.forward(self.trees['fusion'], (s_f, t_f, i_f),
                                 (s_p, t_p, i_p), prec)
        out = []
        for j in range(len(reqs)):
            out.append({k: v[j].float().cpu().numpy() for k, v in
                        (('speech', s_p), ('text', t_p), ('image', i_p),
                         ('fusion', f_p))})
        return out

    def run(self, reqs: Sequence, program: Optional[Sequence[Dict]] = None,
            block: int = 32) -> List[Dict[str, np.ndarray]]:
        out = []
        for k in range(0, len(reqs), block):
            out += self.block(reqs[k:k + block],
                              None if program is None
                              else program[k:k + block])
        return out
