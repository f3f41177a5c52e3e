"""Seeded weight trees in the Flax layout the port's engine takes.

The init recipes are a frozen copy of mec_tpu_torch/serving/
synthetic_artifacts.py's tree makers (speech_variables, image_variables,
bert_variables, fusion_variables, mobilenet_variables, forest_arrays),
so that random weights still separate the classes. Only the source of
the random numbers differs: every normal and uniform leaf of one model
set is drawn on the run's device by one torch.Generator in two calls
(one randn, one rand over all leaves at once), copied to the host once,
and each leaf is a scaled view of that buffer. The forest's structure
(a few thousand small draws) comes from numpy. The same trees go to the
program and, made again from the same seed, to the reference.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

# torchvision mobilenet_v2 inverted-residual settings (t, c, n, s)
INVERTED_RESIDUAL_CFG = (
    (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
    (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))


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
    if isinstance(tree, dict):
        return {k: resolve(v) for k, v in tree.items()}
    if isinstance(tree, _Leaf):
        return tree.value
    return tree


def _zeros(*shape):
    return np.zeros(shape, np.float32)


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


def _bn(d: Draws, c, lo=0.5, hi=1.5):
    return ({'scale': d.uniform(lo, hi, c), 'bias': d.normal(c, std=0.02)},
            {'mean': d.normal(c, std=0.02), 'var': d.uniform(0.5, 2.0, c)})


def _conv(d: Draws, kh, kw, cin, cout, fan_in=None):
    return {'kernel': d.normal(kh, kw, cin, cout,
                               std=np.sqrt(2.0 / (fan_in or kh * kw * cin)))}


def _head(d: Draws, cin: int, n_classes: int, fc2_scale: float) -> Dict:
    return {'fc1': {'kernel': d.normal(cin, 512, std=1 / np.sqrt(cin)),
                    'bias': d.normal(512, std=0.05)},
            'fc2': {'kernel': d.normal(512, n_classes,
                                       std=fc2_scale / np.sqrt(512)),
                    'bias': d.normal(n_classes, std=0.05)}}


def _center_head(tree: Dict) -> None:
    """Zero-mean weights into each fc1 unit and each class."""
    for k in ('fc1', 'fc2'):
        w = tree['params'][k]['kernel']
        w -= w.mean(axis=0)


# ---------------------------------------------------------------- image
def resnet50_plan(d: Draws, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                  n_classes: int = 7) -> Dict:
    """ResNet50: He-normal HWIO kernels, BN as _bn with the residual
    branches' last BN at [0.2, 0.5]; head 2048 -> 512 -> 7 with fc2 at
    16x lecun scale."""
    params, stats = {}, {}
    params['conv1'] = _conv(d, 7, 7, 3, 64)
    params['bn1'], stats['bn1'] = _bn(d, 64)
    cin = 64
    for stage, n_blocks in enumerate(stage_sizes):
        f = 64 * 2 ** stage
        for block in range(n_blocks):
            p, s = {}, {}
            p['conv1'] = _conv(d, 1, 1, cin, f)
            p['bn1'], s['bn1'] = _bn(d, f)
            p['conv2'] = _conv(d, 3, 3, f, f)
            p['bn2'], s['bn2'] = _bn(d, f)
            p['conv3'] = _conv(d, 1, 1, f, 4 * f)
            p['bn3'], s['bn3'] = _bn(d, 4 * f, 0.2, 0.5)
            if block == 0:
                p['downsample_conv'] = _conv(d, 1, 1, cin, 4 * f)
                p['downsample_bn'], s['downsample_bn'] = _bn(d, 4 * f,
                                                             0.2, 0.5)
            params[f'layer{stage + 1}_{block}'] = p
            stats[f'layer{stage + 1}_{block}'] = s
            cin = 4 * f
    params.update(_head(d, cin, n_classes, 16.0))
    return {'params': params, 'batch_stats': stats}


def mobilenet_v2_plan(d: Draws, n_classes: int = 7) -> Dict:
    """MobileNetV2 (width 1.0): He-normal kernels (a depthwise one
    (3, 3, 1, C) with fan-in 9), project_bn at [1, 2] where a stage
    begins and [0.3, 0.6] in a residual block; fc2 at 4x lecun scale."""
    params, stats = {}, {}
    params['conv_stem'] = _conv(d, 3, 3, 3, 32)
    params['bn_stem'], stats['bn_stem'] = _bn(d, 32)
    idx, cin = 1, 32
    for t, c, n, _s in INVERTED_RESIDUAL_CFG:
        for i in range(n):
            hidden = cin * t
            p, st = {}, {}
            if t != 1:
                p['expand_conv'] = _conv(d, 1, 1, cin, hidden)
                p['expand_bn'], st['expand_bn'] = _bn(d, hidden)
            p['dw_conv'] = _conv(d, 3, 3, 1, hidden, fan_in=9)
            p['dw_bn'], st['dw_bn'] = _bn(d, hidden)
            p['project_conv'] = _conv(d, 1, 1, hidden, c)
            p['project_bn'], st['project_bn'] = _bn(
                d, c, *((0.3, 0.6) if i else (1.0, 2.0)))
            params[f'block_{idx}'], stats[f'block_{idx}'] = p, st
            cin = c
            idx += 1
    params['conv_head'] = _conv(d, 1, 1, cin, 1280)
    params['bn_head'], stats['bn_head'] = _bn(d, 1280)
    params.update(_head(d, 1280, n_classes, 4.0))
    return {'params': params, 'batch_stats': stats}


# ---------------------------------------------------------------- text
def bert_plan(d: Draws, vocab_size: int = 30522, hidden_size: int = 768,
              num_hidden_layers: int = 12, intermediate_size: int = 3072,
              max_position_embeddings: int = 512, type_vocab_size: int = 2,
              num_labels: int = 7, **_ignored) -> Dict:
    """BERT's own init (N(0, 0.02) embeddings and kernels, zero biases,
    LayerNorm scale 1); the pooler at lecun scale, the classifier at 8x
    lecun scale (columns centred after the draw)."""
    h, f = hidden_size, intermediate_size

    def dense(din, dout):
        return {'kernel': d.normal(din, dout, std=0.02),
                'bias': _zeros(dout)}

    def norm(n):
        return {'scale': np.ones(n, np.float32), 'bias': _zeros(n)}

    params = {'word_embeddings': {'embedding': d.normal(vocab_size, h,
                                                        std=0.02)},
              'position_embeddings': {'embedding': d.normal(
                  max_position_embeddings, h, std=0.02)},
              'token_type_embeddings': {'embedding': d.normal(
                  type_vocab_size, h, std=0.02)},
              'embeddings_norm': norm(h)}
    for i in range(num_hidden_layers):
        params[f'layer_{i}'] = {
            'attention_self': {n: dense(h, h)
                               for n in ('query', 'key', 'value')},
            'attention_output': dense(h, h),
            'attention_norm': norm(h),
            'intermediate': dense(h, f),
            'output': dense(f, h),
            'output_norm': norm(h)}
    params['pooler'] = {'kernel': d.normal(h, h, std=1 / np.sqrt(h)),
                        'bias': _zeros(h)}
    params['classifier'] = {'kernel': d.normal(h, num_labels,
                                               std=8 / np.sqrt(h)),
                            'bias': _zeros(num_labels)}
    return {'params': params}


def _bert_post(tree: Dict) -> None:
    """The special tokens' rows (ids 0-4), position 0 and token type 0
    are zero, so [CLS] is made by attention over the text; the
    classifier's columns are centred."""
    p = tree['params']
    p['word_embeddings']['embedding'][:5] = 0.0
    p['position_embeddings']['embedding'][0] = 0.0
    p['token_type_embeddings']['embedding'][0] = 0.0
    k = p['classifier']['kernel']
    k -= k.mean(axis=0)


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


IMAGE_PLANS = {'resnet50': resnet50_plan, 'mobilenet_v2': mobilenet_v2_plan}


def make_trees(cfg: Dict, seed: int, device) -> Dict[str, Any]:
    """Every tree of a configuration from one seed: 'speech', 'bert',
    'image' (and 'image_meta'), 'fusion' (attention) or 'forest' and
    'forest_meta' (rf)."""
    from benchmark.harness.traffic import torch_seed
    d = Draws()
    plans = {'speech': speech_plan(d, **cfg['speech']),
             'bert': bert_plan(d, **cfg['text']),
             'image': IMAGE_PLANS[cfg['image']['arch']](d)}
    fus = cfg['fusion']
    if fus['kind'] == 'attention':
        plans['fusion'] = fusion_plan(d, **{k: v for k, v in fus.items()
                                            if k != 'kind'})
    d.run(torch_seed(seed, 10), device)
    trees = {k: resolve(v) for k, v in plans.items()}
    _bert_post(trees['bert'])
    _center_head(trees['image'])
    trees['image_meta'] = {'arch': cfg['image']['arch'],
                           'img_size': cfg['image']['img_size']}
    if fus['kind'] == 'rf':
        trees['forest'], trees['forest_meta'] = forest(
            torch_seed(seed, 11), fus['n_estimators'], fus['max_depth'],
            3 * fus['num_classes'], fus['num_classes'])
    return trees
