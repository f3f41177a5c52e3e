"""Random-init speech, image, BERT, fusion and forest parameters for
smoke runs and tests, and a models directory of them.

The port's counterpart of mec_tpu/serving/synthetic_artifacts.py: the
reference ships no weights, so the serving graph runs on random ones,
made with numpy from a seed (jax.random keys and torch generators give
different numbers from one seed; numpy feeds both packages the same).
The trees have the Flax layout the JAX package uses, which is what the
port's engine takes; make_vocab is the JAX package's synthetic
WordPiece vocab. write_synthetic_artifacts writes them as .mecp files in
the JAX writer's directory layout (convert/store.py), so a full-width
models directory is made on a machine without jax or sklearn.
"""

from __future__ import annotations

import json
import os
import string
from typing import Any, Dict, Sequence, Tuple

import numpy as np

from mec_tpu_torch.convert import store
from mec_tpu_torch.models.mobilenet import INVERTED_RESIDUAL_CFG


def speech_variables(seed: int = 0, in_dim: int = 56,
                     widths: Sequence[int] = (512, 512, 256, 128, 64),
                     n_classes: int = 7) -> Dict:
    """Full-width SpeechDNN {'params', 'batch_stats'} tree of float32
    numpy arrays: lecun-normal Dense kernels (the output layer's doubled
    so random weights still separate the classes), small biases, BN
    scale in [0.5, 1.5] and running var in [0.5, 2]."""
    rng = np.random.RandomState(seed)
    params, stats = {}, {}
    d = in_dim
    for i, w in enumerate(widths):
        params[f'dense_{i}'] = {
            'kernel': (rng.randn(d, w) / np.sqrt(d)).astype(np.float32),
            'bias': (0.05 * rng.randn(w)).astype(np.float32)}
        params[f'bn_{i}'] = {
            'scale': rng.uniform(0.5, 1.5, w).astype(np.float32),
            'bias': (0.1 * rng.randn(w)).astype(np.float32)}
        stats[f'bn_{i}'] = {
            'mean': (0.1 * rng.randn(w)).astype(np.float32),
            'var': rng.uniform(0.5, 2.0, w).astype(np.float32)}
        d = w
    params['dense_out'] = {
        'kernel': (2.0 * rng.randn(d, n_classes) / np.sqrt(d)
                   ).astype(np.float32),
        'bias': (0.05 * rng.randn(n_classes)).astype(np.float32)}
    return {'params': params, 'batch_stats': stats}


def _bn(rng, c, lo=0.5, hi=1.5):
    """BatchNorm params and running statistics: scale in [lo, hi], small
    shifts, running var in [0.5, 2]."""
    p = {'scale': rng.uniform(lo, hi, c).astype(np.float32),
         'bias': (0.02 * rng.randn(c)).astype(np.float32)}
    s = {'mean': (0.02 * rng.randn(c)).astype(np.float32),
         'var': rng.uniform(0.5, 2.0, c).astype(np.float32)}
    return p, s


def image_variables(seed: int = 0, image_size: int = 224,
                    stage_sizes: Sequence[int] = (3, 4, 6, 3),
                    n_classes: int = 7) -> Tuple[Dict, Dict]:
    """Full-width ResNet50 {'params', 'batch_stats'} tree of float32 numpy
    arrays in the Flax layout of mec_tpu/models/resnet.py, and its meta
    ({'img_size': image_size}).

    He-normal conv kernels (HWIO) keep each conv's output at its input's
    scale; BN running var in [0.5, 2] and scale in [0.5, 1.5] keep it
    there, and the last BN of every residual branch (bn3,
    downsample_bn) scales by [0.2, 0.5] so the residual stream grows
    slowly and stays finite through all 16 blocks. BN shifts (bias,
    running mean) are small (0.02 N(0, 1)): larger constant shifts make
    every image's pooled features alike. The head is Dense
    2048->512->7. Pooled features of a random net still share a large
    positive component (and so do the post-ReLU head features), so the
    weights into each fc1 unit and each class are made zero-mean (they
    read the image-dependent part), and fc2 is at 16x lecun scale:
    random weights then separate the classes."""
    rng = np.random.RandomState(seed)

    def conv(kh, kw, cin, cout):
        std = np.sqrt(2.0 / (kh * kw * cin))
        return {'kernel': (std * rng.randn(kh, kw, cin, cout)
                           ).astype(np.float32)}

    def bn(c, lo=0.5, hi=1.5):
        return _bn(rng, c, lo, hi)

    params, stats = {}, {}
    params['conv1'] = conv(7, 7, 3, 64)
    params['bn1'], stats['bn1'] = bn(64)
    cin = 64
    for stage, n_blocks in enumerate(stage_sizes):
        f = 64 * 2 ** stage
        for block in range(n_blocks):
            p, s = {}, {}
            p['conv1'] = conv(1, 1, cin, f)
            p['bn1'], s['bn1'] = bn(f)
            p['conv2'] = conv(3, 3, f, f)
            p['bn2'], s['bn2'] = bn(f)
            p['conv3'] = conv(1, 1, f, 4 * f)
            p['bn3'], s['bn3'] = bn(4 * f, 0.2, 0.5)
            if block == 0:
                p['downsample_conv'] = conv(1, 1, cin, 4 * f)
                p['downsample_bn'], s['downsample_bn'] = bn(4 * f, 0.2, 0.5)
            params[f'layer{stage + 1}_{block}'] = p
            stats[f'layer{stage + 1}_{block}'] = s
            cin = 4 * f
    k1 = rng.randn(cin, 512) / np.sqrt(cin)
    params['fc1'] = {
        'kernel': (k1 - k1.mean(axis=0)).astype(np.float32),
        'bias': (0.05 * rng.randn(512)).astype(np.float32)}
    k2 = 16.0 * rng.randn(512, n_classes) / np.sqrt(512)
    params['fc2'] = {
        'kernel': (k2 - k2.mean(axis=0)).astype(np.float32),
        'bias': (0.05 * rng.randn(n_classes)).astype(np.float32)}
    return ({'params': params, 'batch_stats': stats},
            {'img_size': image_size})


_WORDS = ('the a i you it is was happy sad angry fear disgust surprise '
          'neutral love hate great terrible wonderful awful day today feel '
          'feeling so very really not no yes and or but this that').split()


def make_vocab() -> Dict[str, int]:
    """Small, deterministic WordPiece-compatible vocab (a copy of
    mec_tpu/serving/synthetic_artifacts.py::make_vocab)."""
    tokens = ['[PAD]', '[UNK]', '[CLS]', '[SEP]', '[MASK]']
    tokens += list(string.ascii_lowercase) + list(string.digits)
    tokens += ['##' + c for c in string.ascii_lowercase + string.digits]
    tokens += _WORDS
    return {t: i for i, t in enumerate(tokens)}


def bert_variables(seed: int = 0, vocab_size: int = 30522,
                   hidden_size: int = 768, num_layers: int = 12,
                   intermediate_size: int = 3072,
                   max_position: int = 512, type_vocab_size: int = 2,
                   num_classes: int = 7, num_experts: int = 0) -> Dict:
    """BERT {'params'} tree of float32 numpy arrays in the Flax layout of
    mec_tpu/models/bert.py, at the bert-base-uncased widths by default
    (its 12 heads split the hidden width and are no shape of the tree).

    The encoder is BERT's own init: embeddings and kernels N(0, 0.02),
    zero biases, LayerNorm scale 1. At that scale every text's [CLS]
    state is dominated by the [CLS] embedding itself and all decisions
    come out alike, so two changes make random weights text-dependent:
    the embedding rows of make_vocab's five special tokens (ids 0-4)
    and of position 0 and token type 0 are zero, so the [CLS] state
    starts at zero and is made by attention over the text alone; and
    the pooler is at lecun scale and the classifier at 8x lecun scale
    with zero-mean columns.

    num_experts > 0: every layer's FFN is mec_tpu/models/moe.py's expert
    bank ('moe': router {kernel (H, E) at lecun scale, so routing is
    decided by the hidden state and not by near-ties, bias 0}; wi
    (E, H, F), wo (E, F, H) N(0, 0.02) like the dense FFN; bi, bo 0) in
    place of 'intermediate' and 'output', drawn after the attention of
    its layer.
    """
    rng = np.random.RandomState(seed)

    def normal(*shape, std=0.02):
        return (std * rng.randn(*shape)).astype(np.float32)

    def dense(din, dout):
        return {'kernel': normal(din, dout),
                'bias': np.zeros(dout, np.float32)}

    def norm(d):
        return {'scale': np.ones(d, np.float32),
                'bias': np.zeros(d, np.float32)}

    h, f = hidden_size, intermediate_size
    params = {'word_embeddings': {'embedding': normal(vocab_size, h)},
              'position_embeddings': {'embedding': normal(max_position, h)},
              'token_type_embeddings': {
                  'embedding': normal(type_vocab_size, h)},
              'embeddings_norm': norm(h)}
    params['word_embeddings']['embedding'][:5] = 0.0
    params['position_embeddings']['embedding'][0] = 0.0
    params['token_type_embeddings']['embedding'][0] = 0.0
    for i in range(num_layers):
        layer = params[f'layer_{i}'] = {
            'attention_self': {n: dense(h, h)
                               for n in ('query', 'key', 'value')},
            'attention_output': dense(h, h),
            'attention_norm': norm(h)}
        if num_experts > 0:
            e = num_experts
            layer['moe'] = {
                'router': {'kernel': normal(h, e, std=1.0 / np.sqrt(h)),
                           'bias': np.zeros(e, np.float32)},
                'wi': normal(e, h, f), 'wo': normal(e, f, h),
                'bi': np.zeros((e, f), np.float32),
                'bo': np.zeros((e, h), np.float32)}
        else:
            layer['intermediate'] = dense(h, f)
            layer['output'] = dense(f, h)
        layer['output_norm'] = norm(h)
    params['pooler'] = {'kernel': normal(h, h, std=1.0 / np.sqrt(h)),
                        'bias': np.zeros(h, np.float32)}
    k = normal(h, num_classes, std=8.0 / np.sqrt(h))
    params['classifier'] = {'kernel': k - k.mean(axis=0),
                            'bias': np.zeros(num_classes, np.float32)}
    return {'params': params}


def fusion_variables(seed: int = 0, speech_dim: int = 64,
                     text_dim: int = 768, image_dim: int = 512,
                     hidden_dim: int = 256, num_classes: int = 7) -> Dict:
    """MultiModalFusionModel {'params'} tree of float32 numpy arrays in
    the Flax layout of mec_tpu/models/fusion.py: lecun-normal Dense
    kernels (in, out), xavier-uniform packed MHA in-projections in
    torch's (3e, e) layout, small biases, LayerNorm scale in
    [0.8, 1.2]."""
    rng = np.random.RandomState(seed)
    h = hidden_dim

    def dense(din, dout):
        return {'kernel': (rng.randn(din, dout) / np.sqrt(din)
                           ).astype(np.float32),
                'bias': (0.02 * rng.randn(dout)).astype(np.float32)}

    def norm(d):
        return {'scale': rng.uniform(0.8, 1.2, d).astype(np.float32),
                'bias': (0.02 * rng.randn(d)).astype(np.float32)}

    def proj(din):
        return {'linear': dense(din, h), 'norm': norm(h)}

    lim = np.sqrt(6.0 / (h + 3 * h))
    params = {}
    for mod, d in (('speech', speech_dim), ('text', text_dim),
                   ('image', image_dim)):
        params[f'{mod}_proj'] = proj(d)
    for mod in ('speech', 'text', 'image'):
        params[f'cross_attn_{mod}'] = {
            'attention': {
                'in_proj_weight': rng.uniform(-lim, lim, (3 * h, h)
                                              ).astype(np.float32),
                'in_proj_bias': (0.02 * rng.randn(3 * h)).astype(np.float32),
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


def layer1_quant_params(seed: int = 0) -> Dict:
    """Static-int8 QuantConv params of ResNet50 layer1 ({'layer1_0':
    {'conv1': ..., 'downsample_conv': ...}, 'layer1_1': ..., ...}), the
    recipe of the JAX package's layer1 kernel test
    (tests/test_pallas_resnet.py::_quant_params): kernels 0.1 * N(0, 1),
    per-channel scales, biases 0.05 * N(0, 1), act scales in
    [0.01, 0.05]."""
    rng = np.random.RandomState(seed)

    def conv(cin, cout, ksize=1):
        kw = rng.randn(ksize, ksize, cin, cout).astype(np.float32) * 0.1
        ks = np.abs(kw).max(axis=(0, 1, 2)) / 127.0 + 1e-8
        return {'kernel_q': np.clip(np.round(kw / ks), -127, 127
                                    ).astype(np.int8),
                'kernel_scale': ks.astype(np.float32),
                'bias': (rng.randn(cout) * 0.05).astype(np.float32),
                'act_scale': np.float32(rng.uniform(0.01, 0.05))}

    params = {}
    for blk in range(3):
        cin = 64 if blk == 0 else 256
        p = {'conv1': conv(cin, 64), 'conv2': conv(64, 64, 3),
             'conv3': conv(64, 256)}
        if blk == 0:
            p['downsample_conv'] = conv(64, 256)
        params[f'layer1_{blk}'] = p
    return params


def mobilenet_variables(seed: int = 0, image_size: int = 224,
                        n_classes: int = 7) -> Tuple[Dict, Dict]:
    """MobileNetV2 (width 1.0) {'params', 'batch_stats'} tree of float32
    numpy arrays in the Flax layout of mec_tpu/models/mobilenet.py, and
    its meta ({'arch': 'mobilenet_v2', 'img_size': image_size}).

    He-normal conv kernels (HWIO; a depthwise kernel is (3, 3, 1, C)
    with fan-in 9) and BN as in image_variables. project_bn scales by
    [1, 2] where a stage begins (the stream is replaced) and by
    [0.3, 0.6] in a residual block (it is added to): smaller scales let
    the activations, and their dependence on the image, fade over the
    17 blocks. The head is image_variables' recipe at 4x lecun scale
    for fc2: zero-mean weights into each fc1 unit and class, so random
    weights separate the classes (at 224 px and 32 px alike)."""
    rng = np.random.RandomState(seed)

    def conv(kh, kw, cin, cout, fan_in=None):
        std = np.sqrt(2.0 / (fan_in or kh * kw * cin))
        return {'kernel': (std * rng.randn(kh, kw, cin, cout)
                           ).astype(np.float32)}

    params, stats = {}, {}
    params['conv_stem'] = conv(3, 3, 3, 32)
    params['bn_stem'], stats['bn_stem'] = _bn(rng, 32)
    idx, cin = 1, 32
    for t, c, n, _s in INVERTED_RESIDUAL_CFG:
        for i in range(n):
            hidden = cin * t
            p, st = {}, {}
            if t != 1:
                p['expand_conv'] = conv(1, 1, cin, hidden)
                p['expand_bn'], st['expand_bn'] = _bn(rng, hidden)
            p['dw_conv'] = conv(3, 3, 1, hidden, fan_in=9)
            p['dw_bn'], st['dw_bn'] = _bn(rng, hidden)
            p['project_conv'] = conv(1, 1, hidden, c)
            p['project_bn'], st['project_bn'] = _bn(
                rng, c, *((0.3, 0.6) if i else (1.0, 2.0)))
            params[f'block_{idx}'], stats[f'block_{idx}'] = p, st
            cin = c
            idx += 1
    params['conv_head'] = conv(1, 1, cin, 1280)
    params['bn_head'], stats['bn_head'] = _bn(rng, 1280)
    k1 = rng.randn(1280, 512) / np.sqrt(1280)
    params['fc1'] = {
        'kernel': (k1 - k1.mean(axis=0)).astype(np.float32),
        'bias': (0.05 * rng.randn(512)).astype(np.float32)}
    k2 = 4.0 * rng.randn(512, n_classes) / np.sqrt(512)
    params['fc2'] = {
        'kernel': (k2 - k2.mean(axis=0)).astype(np.float32),
        'bias': (0.05 * rng.randn(n_classes)).astype(np.float32)}
    return ({'params': params, 'batch_stats': stats},
            {'arch': 'mobilenet_v2', 'img_size': image_size})


def forest_arrays(seed: int = 0, n_trees: int = 100, depth: int = 12,
                  n_features: int = 21, n_classes: int = 7
                  ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """A random forest in the layout of mec_tpu/models/forest.py::
    from_sklearn (arrays, meta), made with numpy alone: the defaults are
    mec_tpu/training/train_fusion_rf.py's (100 trees, depth 12, the 21
    concatenated softmax outputs).

    Each tree grows level by level: a node splits with probability 0.8
    (the first node of every level always, so every tree reaches
    `depth`) on a random feature at a threshold in [0.02, 0.3] (the
    inputs are probabilities near 1/7); leaves and padding self-loop;
    every node carries a Dirichlet(0.5) class distribution, padding
    zeros."""
    rng = np.random.RandomState(seed)
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


def write_synthetic_artifacts(models_dir: str, *, tiny: bool = False,
                              seed: int = 0, image_arch: str = 'resnet50',
                              image_size: int = 224, bert_experts: int = 0,
                              moe_capacity_factor: float = 1.25) -> str:
    """Populate `models_dir` with the JAX writer's artifacts
    (mec_tpu/serving/synthetic_artifacts.py::write_synthetic_artifacts)
    from the numpy trees above, through the port's store: the speech DNN
    with an identity scaler, the BERT dir (bert_model.mecp, config.json,
    vocab.txt), the image model with its meta (arch, img_size), the
    fusion net with its config, and fusion_rf.mecp (100 trees of depth
    12; tiny: 8 of depth 6). No Bi-LSTM: the port does not serve one.
    Full width by default (BERT-base with vocab 30522); tiny: a 2-layer
    BERT of width 64 over make_vocab. bert_experts > 0: the BERT is a
    mixture-of-experts one (bert_variables' num_experts; its config.json
    carries num_experts and moe_capacity_factor, as train-text-bert
    --experts writes them). Returns the dir."""
    os.makedirs(models_dir, exist_ok=True)
    store.save_params(os.path.join(models_dir, 'speech_model.mecp'),
                      speech_variables(seed))
    np.savez(os.path.join(models_dir, 'speech_scaler.npz'),
             mean=np.zeros(56, np.float32), scale=np.ones(56, np.float32))

    vocab = make_vocab()
    if tiny:
        widths = dict(vocab_size=len(vocab), hidden_size=64, num_layers=2,
                      intermediate_size=128, max_position=128)
        heads = 2
    else:
        widths = dict(vocab_size=30522, hidden_size=768, num_layers=12,
                      intermediate_size=3072, max_position=512)
        heads = 12
    bert_dir = os.path.join(models_dir, 'bert_model')
    store.save_params(os.path.join(bert_dir, 'bert_model.mecp'),
                      bert_variables(seed + 1, **widths,
                                     num_experts=bert_experts))
    cfg = {'vocab_size': widths['vocab_size'],
           'hidden_size': widths['hidden_size'],
           'num_hidden_layers': widths['num_layers'],
           'num_attention_heads': heads,
           'intermediate_size': widths['intermediate_size'],
           'max_position_embeddings': widths['max_position'],
           'type_vocab_size': 2, 'num_labels': 7}
    if bert_experts > 0:
        cfg.update(num_experts=bert_experts,
                   moe_capacity_factor=moe_capacity_factor)
    with open(os.path.join(bert_dir, 'config.json'), 'w') as f:
        json.dump(cfg, f)
    inv = sorted(vocab.items(), key=lambda kv: kv[1])
    with open(os.path.join(bert_dir, 'vocab.txt'), 'w') as f:
        f.write('\n'.join(t for t, _ in inv))

    if image_arch == 'mobilenet_v2':
        image, meta = mobilenet_variables(seed + 2, image_size)
    elif image_arch == 'resnet50':
        image, meta = image_variables(seed + 2, image_size)
        meta = {'arch': 'resnet50', **meta}
    else:
        raise ValueError(f'image_arch {image_arch!r}: expected resnet50 or '
                         'mobilenet_v2')
    store.save_params(os.path.join(models_dir, 'image_model.mecp'), image,
                      meta=meta)

    cfg = {'speech_dim': 64, 'text_dim': widths['hidden_size'],
           'image_dim': 512, 'num_classes': 7, 'hidden_dim': 256}
    store.save_params(os.path.join(models_dir, 'fusion_model.mecp'),
                      fusion_variables(seed + 3, **cfg), meta={'config': cfg})

    arrays, meta = forest_arrays(seed + 4, *((8, 6) if tiny else (100, 12)))
    store.save_params(os.path.join(models_dir, 'fusion_rf.mecp'),
                      {'forest': arrays}, meta=meta)
    return models_dir
