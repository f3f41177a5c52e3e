"""The port's random-forest walk (mec_tpu_torch/models/forest.py) against
sklearn and the JAX package's forest_apply (mec_tpu/models/forest.py).

Forests are fitted by sklearn (the oracle itself) and converted by the
JAX package's from_sklearn. Contracts: forest_leaves equals
RandomForestClassifier.apply on the float32 inputs exactly (same
comparisons in fp32, and from_sklearn keeps sklearn's node ids);
forest_apply is within 1e-6 of the JAX forest_apply on identical inputs
(the same leaves; only the order of the mean over trees differs) and of
predict_proba. The cases are tests/test_forest.py's (unbounded depth,
stumps, a single-leaf tree, ragged tree sizes), a forest fitted on a
subset of the classes, and the port's synthetic forest
(serving/synthetic_artifacts.forest_arrays).
"""

import numpy as np
import pytest
import torch

from mec_tpu.models import forest as jforest
from mec_tpu_torch.config import Config
from mec_tpu_torch.convert.from_jax import forest_from_jax
from mec_tpu_torch.models.forest import forest_apply, forest_leaves
from mec_tpu_torch.serving.engine import EmotionEngine
from mec_tpu_torch.serving.synthetic_artifacts import forest_arrays


def _fit_rf(n_estimators=25, n_features=21, n_classes=7, n_samples=500,
            seed=0, labels=None, **kw):
    from sklearn.ensemble import RandomForestClassifier
    rng = np.random.RandomState(seed)
    x = rng.rand(n_samples, n_features).astype(np.float32)
    y = (x[:, :n_classes].argmax(axis=1) + rng.randint(0, 2, n_samples)
         ) % n_classes
    if labels is not None:
        y = np.asarray(labels)[y % len(labels)]
    rf = RandomForestClassifier(n_estimators=n_estimators, random_state=seed,
                                **kw).fit(x, y)
    return rf, rng.rand(64, n_features).astype(np.float32)


def _port(arrays, x, depth):
    t = forest_from_jax(arrays)
    xt = torch.from_numpy(x)
    return (forest_leaves(t, xt, depth).numpy(),
            forest_apply(t, xt, depth).numpy())


@pytest.mark.parametrize('case', ['unbounded', 'stumps', 'ragged',
                                  'single_leaf', 'class_subset'])
def test_forest_matches_sklearn_and_jax(case):
    if case == 'single_leaf':
        # one training class: every tree is a root leaf (max_depth 0)
        from sklearn.ensemble import RandomForestClassifier
        x = np.random.RandomState(0).rand(20, 21).astype(np.float32)
        rf = RandomForestClassifier(n_estimators=3, random_state=0).fit(
            x, np.zeros(20, np.int64))
    else:
        kw = {'unbounded': {},
              'stumps': dict(n_estimators=8, max_depth=1),
              'ragged': dict(n_estimators=12, n_samples=900),
              'class_subset': dict(n_estimators=10, max_depth=6,
                                   labels=[0, 2, 5])}[case]
        rf, x = _fit_rf(**kw)
    arrays, meta = jforest.from_sklearn(rf)
    if case == 'ragged':
        assert len({e.tree_.node_count for e in rf.estimators_}) > 1
    leaves, probs = _port(arrays, x, meta['depth'])
    np.testing.assert_array_equal(leaves, rf.apply(x))
    want = np.asarray(jforest.forest_apply(arrays, x, meta['depth']))
    np.testing.assert_allclose(probs, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(probs, rf.predict_proba(x), atol=1e-6, rtol=0)
    assert probs.shape == (len(x), len(meta['classes']))


def test_synthetic_forest_layout_and_walk():
    """forest_arrays: the from_sklearn layout (int32 topology, float32
    thresholds, leaves and padding self-loop, every tree reaches the
    stated depth); the port's walk equals a per-tree numpy walk and the
    JAX forest_apply."""
    arrays, meta = forest_arrays(seed=5, n_trees=6, depth=7)
    assert meta == {'kind': 'random_forest', 'depth': 7, 'n_features': 21,
                    'n_classes': 7, 'classes': list(range(7))}
    assert arrays['feature'].dtype == arrays['left'].dtype == np.int32
    assert arrays['threshold'].dtype == arrays['proba'].dtype == np.float32
    T, N = arrays['feature'].shape
    nodes = np.arange(N)
    for t in range(T):
        leaf = arrays['left'][t] == nodes
        assert (arrays['right'][t][leaf] == nodes[leaf]).all()
        depth, level = 0, [0]
        while True:
            level = [c for n in level if arrays['left'][t, n] != n
                     for c in (arrays['left'][t, n], arrays['right'][t, n])]
            if not level:
                break
            depth += 1
        assert depth == 7
    x = np.random.RandomState(1).dirichlet(np.ones(7), (40, 3)).reshape(
        40, 21).astype(np.float32)
    leaves, probs = _port(arrays, x, meta['depth'])
    for b in range(0, 40, 7):
        for t in range(T):
            n = 0
            while arrays['left'][t, n] != n:
                go_left = x[b, arrays['feature'][t, n]] \
                    <= arrays['threshold'][t, n]
                n = arrays['left' if go_left else 'right'][t, n]
            assert leaves[b, t] == n
    np.testing.assert_allclose(
        probs, np.asarray(jforest.forest_apply(arrays, x, meta['depth'])),
        atol=1e-6, rtol=0)


def test_forest_from_jax_dtypes():
    arrays, _ = forest_arrays(seed=0, n_trees=2, depth=3)
    t = forest_from_jax(arrays)
    assert t['feature'].dtype == t['left'].dtype == torch.int64
    assert t['threshold'].dtype == t['proba'].dtype == torch.float32
    bad = dict(arrays, threshold=arrays['threshold'].astype(np.float64))
    with pytest.raises(ValueError, match='threshold is float64'):
        forest_from_jax(bad)


@pytest.fixture()
def rf_mode(monkeypatch):
    monkeypatch.setattr(Config, 'FUSION_MODE', 'rf')


def test_engine_forest_tail_scatters_a_class_subset(rf_mode):
    """The engine's rf tail (JAX forest_fwd, engine.py:870-877): the
    forest's probabilities at its classes, 0 at the others."""
    rf, x = _fit_rf(n_estimators=10, max_depth=6, labels=[1, 3, 4, 6])
    arrays, meta = jforest.from_sklearn(rf)
    engine = EmotionEngine(forest_arrays=arrays, forest_meta=meta,
                           device='cpu')
    assert engine._fusion_kind == 'rf' and not engine._all_live
    s, t, i = (torch.from_numpy(x[:, k:k + 7]) for k in (0, 7, 14))
    got = engine._forest_forward(s, t, i).numpy()
    want = np.zeros((len(x), 7), np.float32)
    want[:, [1, 3, 4, 6]] = rf.predict_proba(x)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize('meta,match', [
    ({'n_features': 21}, 'depth'),
    ({'depth': 3, 'n_features': 20}, 'expects 20 features'),
    ({'depth': 3, 'classes': [0, 9]}, 'not emotion ids'),
])
def test_engine_rejects_an_unservable_forest(rf_mode, meta, match):
    """The JAX engine logs such an artifact and serves the fallback
    ladder; the port raises."""
    arrays, _ = forest_arrays(seed=0, n_trees=2, depth=3)
    with pytest.raises(ValueError, match=match):
        EmotionEngine(forest_arrays=arrays, forest_meta=meta, device='cpu')
