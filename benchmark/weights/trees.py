"""Seeded weight trees in the Flax layout the port's engine takes.

The init recipes are a frozen copy of mec_tpu_torch/serving/
synthetic_artifacts.py's tree makers (speech_variables, image_variables,
bert_variables, fusion_variables, mobilenet_variables, forest_arrays),
so that random weights still separate the classes; the text and image
recipes live in their legs (benchmark/legs/), the speech and fusion ones
and the pieces the image legs share here. Only the source of the random
numbers differs: every normal and uniform leaf of one model set is drawn
on the run's device by one torch.Generator in two calls (one randn, one
rand over all leaves at once), copied to the host once, and each leaf is
a scaled view of that buffer. A leg too large for that draws its leaves
one at a time instead (benchmark/weights/seeded.py). The forest's
structure (a few thousand small draws) comes from numpy. The same trees
go to the program and, made again from the same seed, to the reference.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch


class _Leaf:
    __slots__ = ('kind', 'shape', 'a', 'b', 'value')

    def __init__(self, kind, shape, a, b):
        self.kind, self.shape, self.a, self.b = kind, tuple(shape), a, b
        self.value = None


class Draws:
    """Collects leaves, then draws them all in two device calls."""

    def __init__(self):
        self.leaves: List[_Leaf] = []

    def normal(self, *shape, std=1.0) -> _Leaf:
        leaf = _Leaf('normal', shape, std, 0.0)
        self.leaves.append(leaf)
        return leaf

    def uniform(self, lo, hi, *shape) -> _Leaf:
        leaf = _Leaf('uniform', shape, lo, hi)
        self.leaves.append(leaf)
        return leaf

    def run(self, seed: int, device) -> None:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        sizes = {k: sum(int(np.prod(l.shape)) for l in self.leaves
                        if l.kind == k) for k in ('normal', 'uniform')}
        bufs = {'normal': torch.randn(sizes['normal'], generator=gen,
                                      device=device),
                'uniform': torch.rand(sizes['uniform'], generator=gen,
                                      device=device)}
        host = {k: v.cpu().numpy() for k, v in bufs.items()}
        off = {'normal': 0, 'uniform': 0}
        for leaf in self.leaves:
            n = int(np.prod(leaf.shape))
            v = host[leaf.kind][off[leaf.kind]:off[leaf.kind] + n]
            off[leaf.kind] += n
            if leaf.kind == 'normal':
                v *= np.float32(leaf.a)
            else:
                v *= np.float32(leaf.b - leaf.a)
                v += np.float32(leaf.a)
            leaf.value = v.reshape(leaf.shape)


def resolve(tree: Any) -> Any:
    """The tree with every Draws leaf replaced by its drawn value."""
    if isinstance(tree, dict):
        return {k: resolve(v) for k, v in tree.items()}
    if isinstance(tree, _Leaf):
        return tree.value
    return tree


# ---------------------------------------------------------------- speech
def speech_plan(d: Draws, in_dim: int = 56,
                widths: Sequence[int] = (512, 512, 256, 128, 64),
                n_classes: int = 7) -> Dict:
    """SpeechDNN: lecun-normal kernels (the output's doubled), small
    biases, BN scale in [0.5, 1.5], running var in [0.5, 2]."""
    params, stats = {}, {}
    din = in_dim
    for i, w in enumerate(widths):
        params[f'dense_{i}'] = {'kernel': d.normal(din, w,
                                                   std=1 / np.sqrt(din)),
                                'bias': d.normal(w, std=0.05)}
        params[f'bn_{i}'] = {'scale': d.uniform(0.5, 1.5, w),
                             'bias': d.normal(w, std=0.1)}
        stats[f'bn_{i}'] = {'mean': d.normal(w, std=0.1),
                            'var': d.uniform(0.5, 2.0, w)}
        din = w
    params['dense_out'] = {'kernel': d.normal(din, n_classes,
                                              std=2 / np.sqrt(din)),
                           'bias': d.normal(n_classes, std=0.05)}
    return {'params': params, 'batch_stats': stats}


# ------------------------------------------- pieces of the image legs
def bn(d: Draws, c, lo=0.5, hi=1.5):
    return ({'scale': d.uniform(lo, hi, c), 'bias': d.normal(c, std=0.02)},
            {'mean': d.normal(c, std=0.02), 'var': d.uniform(0.5, 2.0, c)})


def conv(d: Draws, kh, kw, cin, cout, fan_in=None):
    return {'kernel': d.normal(kh, kw, cin, cout,
                               std=np.sqrt(2.0 / (fan_in or kh * kw * cin)))}


def head(d: Draws, cin: int, n_classes: int, fc2_scale: float) -> Dict:
    return {'fc1': {'kernel': d.normal(cin, 512, std=1 / np.sqrt(cin)),
                    'bias': d.normal(512, std=0.05)},
            'fc2': {'kernel': d.normal(512, n_classes,
                                       std=fc2_scale / np.sqrt(512)),
                    'bias': d.normal(n_classes, std=0.05)}}


def center_head(tree: Dict) -> None:
    """Zero-mean weights into each fc1 unit and each class."""
    for k in ('fc1', 'fc2'):
        w = tree['params'][k]['kernel']
        w -= w.mean(axis=0)


# ---------------------------------------------------------------- fusion
def fusion_plan(d: Draws, speech_dim: int = 64, text_dim: int = 768,
                image_dim: int = 512, hidden_dim: int = 256,
                num_classes: int = 7) -> Dict:
    """Attention fusion: lecun-normal Dense kernels, xavier-uniform
    packed in-projections in torch's (3e, e) layout, small biases,
    LayerNorm scale in [0.8, 1.2]."""
    h = hidden_dim

    def dense(din, dout):
        return {'kernel': d.normal(din, dout, std=1 / np.sqrt(din)),
                'bias': d.normal(dout, std=0.02)}

    def norm(n):
        return {'scale': d.uniform(0.8, 1.2, n), 'bias': d.normal(n, std=0.02)}

    def proj(din):
        return {'linear': dense(din, h), 'norm': norm(h)}

    lim = float(np.sqrt(6.0 / (h + 3 * h)))
    params = {}
    for mod, dim in (('speech', speech_dim), ('text', text_dim),
                     ('image', image_dim)):
        params[f'{mod}_proj'] = proj(dim)
    for mod in ('speech', 'text', 'image'):
        params[f'cross_attn_{mod}'] = {
            'attention': {'in_proj_weight': d.uniform(-lim, lim, 3 * h, h),
                          'in_proj_bias': d.normal(3 * h, std=0.02),
                          'out_proj': dense(h, h)},
            'norm': norm(h)}
    params['attention_fusion'] = {
        'proj_0': proj(h), 'proj_1': proj(h), 'proj_2': proj(h),
        'attn_0': dense(3 * h, h), 'attn_1': dense(h, 3)}
    params['decision_0'] = dense(3 * num_classes, 64)
    params['decision_1'] = dense(64, 3)
    params['classifier_0'] = dense(h + num_classes, h)
    params['classifier_norm'] = norm(h)
    params['classifier_1'] = dense(h, h // 2)
    params['classifier_2'] = dense(h // 2, num_classes)
    return {'params': params}


def forest(seed: int, n_trees: int = 100, depth: int = 12,
           n_features: int = 21, n_classes: int = 7
           ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """A random forest in the layout of the port's forest_apply: each
    tree grows level by level; a node splits with probability 0.8 (the
    first node of every level always) on a random feature at a threshold
    in [0.02, 0.3]; leaves and padding self-loop; every node carries a
    Dirichlet(0.5) class distribution."""
    rng = np.random.RandomState(int(seed) % 2 ** 32)
    trees = []
    for _ in range(n_trees):
        feat, thr, left, right = [0], [0.0], [0], [0]
        level = np.array([0])
        for _d in range(depth):
            split = rng.rand(len(level)) < 0.8
            split[0] = True
            parents = level[split]
            n0 = len(feat)
            kids = n0 + np.arange(2 * len(parents))
            feat += [0] * len(kids)
            thr += [0.0] * len(kids)
            left += list(kids)
            right += list(kids)
            for j, node in enumerate(parents):
                feat[node] = int(rng.randint(n_features))
                thr[node] = float(rng.uniform(0.02, 0.3))
                left[node] = int(kids[2 * j])
                right[node] = int(kids[2 * j + 1])
            for node in level[~split]:
                left[node] = right[node] = int(node)
            level = kids
        trees.append((feat, thr, left, right))
    n_nodes = max(len(t[0]) for t in trees)
    feature = np.zeros((n_trees, n_nodes), np.int32)
    threshold = np.zeros((n_trees, n_nodes), np.float32)
    left = np.tile(np.arange(n_nodes, dtype=np.int32), (n_trees, 1))
    right = left.copy()
    proba = np.zeros((n_trees, n_nodes, n_classes), np.float32)
    for i, (f, t, lo, hi) in enumerate(trees):
        n = len(f)
        feature[i, :n], threshold[i, :n] = f, t
        left[i, :n], right[i, :n] = lo, hi
        proba[i, :n] = rng.dirichlet(0.5 * np.ones(n_classes), n)
    arrays = {'feature': feature, 'threshold': threshold, 'left': left,
              'right': right, 'proba': proba}
    meta = {'kind': 'random_forest', 'depth': int(depth),
            'n_features': int(n_features), 'n_classes': int(n_classes),
            'classes': list(range(n_classes))}
    return arrays, meta




def make_trees(cfg: Dict, seed: int, device) -> Dict[str, Any]:
    """Every tree of a configuration from one seed: 'speech', 'text',
    'image' (and 'image_meta'), 'fusion' (attention) or 'forest' and
    'forest_meta' (rf). The text and image trees are the plans of the
    legs the configuration names (benchmark/legs/text_<text.arch>.py,
    image_<image.arch>.py). Their Draws leaves are drawn in one buffer
    in the order speech, text, image, fusion; their seeded leaves
    (benchmark/weights/seeded.py) are bound to the seed and the device
    and drawn where they are used."""
    from benchmark.harness.cells import leg
    from benchmark.harness.traffic import torch_seed
    from benchmark.weights import seeded
    legs = {k: leg(cfg, k) for k in ('text', 'image')}
    d = Draws()
    plans = {'speech': speech_plan(d, **cfg['speech']),
             'text': legs['text'].plan(d, **cfg['text']),
             'image': legs['image'].plan(d, **cfg['image'])}
    fus = cfg['fusion']
    if fus['kind'] == 'attention':
        plans['fusion'] = fusion_plan(d, **{k: v for k, v in fus.items()
                                            if k != 'kind'})
    d.run(torch_seed(seed, 10), device)
    trees = {k: resolve(v) for k, v in plans.items()}
    for k, mod in legs.items():
        if hasattr(mod, 'post'):
            mod.post(trees[k])
    seeded.bind(trees, seed, device)
    trees['image_meta'] = {'arch': cfg['image']['arch'],
                           'img_size': cfg['image']['img_size']}
    if fus['kind'] == 'rf':
        trees['forest'], trees['forest_meta'] = forest(
            torch_seed(seed, 11), fus['n_estimators'], fus['max_depth'],
            3 * fus['num_classes'], fus['num_classes'])
    return trees
