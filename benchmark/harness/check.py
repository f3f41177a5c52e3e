"""The output check: what each answered request says against the
reference.

A request is served when none of its four answers is a fallback (the
speech, text and image dicts carry no '_fallback', and the fusion is the
configured one: attention weights for the attention net, method
'random_forest' for the forest). The compared numbers are, per modality,
the widest gap |p_program - p_reference| over the sampled requests and
the seven classes, and the mean and the median over the requests of
each one's widest gap, in probabilities and in centred log-probabilities
(logits). The configuration's "check" table names the numbers compared
and their limits.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

MODALITIES = ('speech', 'text', 'image', 'fusion')


def served(answer, fusion_kind: str) -> bool:
    if not isinstance(answer, dict):
        return False
    for k in ('speech', 'text', 'image'):
        a = answer.get(k)
        if not isinstance(a, dict) or a.get('_fallback') \
                or len(a.get('all_probabilities', ())) != 7:
            return False
    f = answer.get('fusion')
    if not isinstance(f, dict):
        return False
    if fusion_kind == 'rf':
        return f.get('method') == 'random_forest'
    return 'attention_weights' in f


def gaps(program: Sequence[Dict], reference: Sequence[Dict]
         ) -> Dict[str, float]:
    """Per modality, over the requests, of each one's widest class gap:
    '<m>_gap' the widest, '<m>_mean_gap' the mean, '<m>_median_gap' the
    median of |p_program - p_reference|; '<m>_logit_gap',
    '<m>_logit_mean_gap' and '<m>_logit_median_gap' the same of the gap
    between the log-probabilities, each centred on its mean over the
    classes (the logits' gap, softmax's shift taken out); '<m>_rel_logit_'
    ... that gap over the spread of the reference's logits (its largest
    less its smallest), which does not grow with how sure a net is."""
    out = {}
    for k in MODALITIES:
        p = np.array([a[k]['all_probabilities'] for a in program], np.float64)
        r = np.array([a[k] for a in reference], np.float64)
        lp, lr = _centred(p), _centred(r)
        dl = np.abs(lp - lr).max(axis=1)
        spread = lr.max(axis=1) - lr.min(axis=1)
        for name, per in (('', np.abs(p - r).max(axis=1)),
                          ('logit_', dl),
                          ('rel_logit_', dl / np.maximum(spread, 1e-12))):
            out[f'{k}_{name}gap'] = float(per.max())
            out[f'{k}_{name}mean_gap'] = float(per.mean())
            out[f'{k}_{name}median_gap'] = float(np.median(per))
    return out


def _centred(p: np.ndarray) -> np.ndarray:
    lp = np.log(np.maximum(p, 1e-30))
    return lp - lp.mean(axis=1, keepdims=True)


def sample(n: int, k: int, rng: np.random.Generator,
           must: Sequence[int] = ()) -> List[int]:
    """k of range(n), drawn by rng, always holding `must`."""
    rest = [i for i in range(n) if i not in set(must)]
    k = min(n, k)
    pick = list(must) + list(rng.choice(rest, max(0, k - len(must)),
                                        replace=False))
    return sorted(int(i) for i in pick)
