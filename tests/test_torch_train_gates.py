"""What the end-to-end fixture's fusion gate measures, on both packages.

The fixture (tests/test_end_to_end.py:139-146: 600 synthetic rows, 6
epochs, batch 64, best val_acc > 0.55) passes for the JAX trainer's
seed-42 stream (0.648); over other seeds both trainers sit near 0.45 and
rarely reach 0.55, because the dropout stream decides the outcome. So:

* from the JAX trainer's own initial parameters with dropout off on both
  sides (the one difference the packages cannot share), the port's
  fusion trainer follows the JAX trainer's history: every epoch's
  val_acc within one validation row (1/91) and its training loss within
  1e-3 relative (measured: equal to 4 decimals; Adam turns float32
  noise on near-zero gradients into steps of up to 2 lr, so the two
  drift apart slowly);
* with dropout on, over training/corpora.FUSION_GATE_SEEDS the port's
  mean reaches corpora.fusion_gate_floor, the gate that chip_smoke.py
  holds the port to on the card; the JAX trainer re-measures the first
  two of corpora.JAX_FUSION_BEST_VAL_ACC (within one validation row: XLA
  on another CPU may round differently; all six cost a minute here).
* learning rates within 1e-5 relative: float32 cos of the cosine
  schedule near its end (measured 2.4e-6).
"""

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from mec_tpu.training import common as jcommon
from mec_tpu.training import train_fusion as jax_fusion
from mec_tpu_torch.convert.from_jax import state_dict_from_jax
from mec_tpu_torch.training import common, corpora, train_fusion


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    """The tier-1 run has six workers on the CPU: torch's default of one
    thread a core in each of them makes these small-op workloads spin on
    each other, so this file keeps torch at two threads and restores
    the count afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


ROW = 1 / 91 + 1e-9
DIMS = {'speech': 64, 'text': 64, 'image': 512}


def _fixture_data():
    return train_fusion.generate_synthetic_data(600, dims=DIMS)


def test_fusion_trainer_follows_jax_from_its_init(monkeypatch, tmp_path):
    monkeypatch.setattr(fnn.Dropout, '__call__',
                        lambda self, inputs, *a, **k: inputs)
    monkeypatch.setattr(torch.nn.Dropout, 'forward', lambda self, x: x)
    init = {}
    jax_fit = jcommon.fit

    def spy(state, *a, **k):
        init['params'] = jax.tree.map(np.asarray, state.params)
        return jax_fit(state, *a, **k)

    monkeypatch.setattr(jcommon, 'fit', spy)
    ds = _fixture_data()
    _v, _c, want = jax_fusion.train(dataset=ds, epochs=6, batch_size=64,
                                    models_dir=str(tmp_path / 'j'),
                                    verbose=False)

    def from_jax(model, seed):
        model.load_state_dict(state_dict_from_jax(model, init))
        return model

    monkeypatch.setattr(common, 'flax_init', from_jax)
    _v, _c, got = train_fusion.train(dataset=ds, epochs=6, batch_size=64,
                                     models_dir=str(tmp_path / 't'),
                                     verbose=False, device='cpu')
    np.testing.assert_allclose(got['val_acc'], want['val_acc'], rtol=0,
                               atol=ROW)
    np.testing.assert_allclose(got['loss'], want['loss'], rtol=1e-3)
    np.testing.assert_allclose(got['lr'], want['lr'], rtol=1e-5)


def test_fusion_gate_is_the_jax_trainers_distribution(tmp_path):
    ds = _fixture_data()
    jax_accs = [max(jax_fusion.train(
        dataset=ds, epochs=6, batch_size=64, seed=seed,
        models_dir=str(tmp_path / 'j'), verbose=False)[2]['val_acc'])
        for seed in corpora.FUSION_GATE_SEEDS[:2]]
    port_accs = [max(train_fusion.train(
        dataset=ds, epochs=6, batch_size=64, seed=seed,
        models_dir=str(tmp_path / 't'), verbose=False,
        device='cpu')[2]['val_acc']) for seed in corpora.FUSION_GATE_SEEDS]
    print(f'JAX {np.round(jax_accs, 4).tolist()}; port '
          f'{np.round(port_accs, 4).tolist()} mean {np.mean(port_accs):.4f};'
          f' floor {corpora.fusion_gate_floor(port_accs):.4f}')
    np.testing.assert_allclose(jax_accs, corpora.JAX_FUSION_BEST_VAL_ACC[:2],
                               rtol=0, atol=ROW)
    assert max(corpora.JAX_FUSION_BEST_VAL_ACC) < 0.55
    assert np.mean(port_accs) >= corpora.fusion_gate_floor(port_accs)


def _sweep(seeds):
    """Best val_acc of both packages' fusion and tiny-BERT trainers at the
    fixture's sizes over `seeds`, on the CPU: the measurement behind
    corpora.JAX_FUSION_BEST_VAL_ACC and ROADMAP.md C10."""
    import tempfile

    from mec_tpu.training import train_text_bert as jax_bert
    from mec_tpu_torch.training import train_text_bert

    work = tempfile.mkdtemp()
    ds = _fixture_data()
    texts, labels = corpora.make_text_corpus(per_class=12)
    tok = corpora.make_bert_tokenizer(texts)
    tiny = dict(vocab_size=len(tok.vocab), hidden_size=64, num_layers=2,
                num_heads=2, intermediate_size=128)
    bert_kw = dict(csv_path=None, texts=texts, labels=labels, tokenizer=tok,
                   epochs=8, batch_size=16, max_length=16,
                   learning_rate=5e-4, model_kwargs=tiny, models_dir=work,
                   verbose=False)
    runs = {
        'fusion JAX': lambda s: jax_fusion.train(
            dataset=ds, epochs=6, batch_size=64, seed=s, models_dir=work,
            verbose=False)[2],
        'fusion port': lambda s: train_fusion.train(
            dataset=ds, epochs=6, batch_size=64, seed=s, models_dir=work,
            verbose=False, device='cpu')[2],
        'bert JAX': lambda s: jax_bert.train(seed=s, **bert_kw)[1],
        'bert port': lambda s: train_text_bert.train(
            seed=s, device='cpu', **bert_kw)[1],
    }
    for name, run in runs.items():
        accs = np.array([max(run(s)['val_acc']) for s in seeds])
        gate = 0.55 if name.startswith('fusion') else 0.85
        print(f'{name}: mean {accs.mean():.4f} std {accs.std():.4f}, above '
              f'{gate} at {int((accs > gate).sum())} of {len(seeds)}: '
              f'{np.round(accs, 4).tolist()}', flush=True)


if __name__ == '__main__':
    # the seed sweep, from the repository root:
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_train_gates.py [first last]
    import sys
    first, last = (int(a) for a in (sys.argv[1:3] or (10, 29)))
    _sweep(range(first, last + 1))
