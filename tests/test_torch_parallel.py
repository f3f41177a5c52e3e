"""The port's data axis (mec_tpu_torch/parallel, the data-parallel fit)
against one process and against the JAX package's mesh.

Two-rank runs are spawned with parallel.launch over gloo on the CPU
(one torch thread a rank, the rank functions in
tests/torch_parallel_workers.py); there are two such spawns here, and
the CLI's own spawn is the third. Tolerances, each with its reason:

* gradients after the all-reduce against one process on the same
  global batch, float64: 1e-10 (a mean of two row-half means against
  one mean, and BatchNorm's statistics and the MoE aux loss from summed
  parts; measured <= 1.1e-15). This holds the global BatchNorm
  statistics (speech DNN), the global MoE aux loss (a product of two
  means, tiny MoE BERT) and the averaging before the clip;
* the module's state after the step: 1e-10 for BatchNorm statistics
  and parameters (one Adam step from equal gradients);
* the batches each rank trains: the JAX order, the ragged tail padded
  by repeating its last row (jcommon.pad_batch), exactly;
* both ranks' histories, parameters and best variables: identical, and
  a run stopped after two epochs and resumed on both ranks from rank
  0's checkpoint ends where the uninterrupted run ends, bit for bit;
* train_speech.train(mesh_data=2) over two ranks against the JAX
  trainer's mesh_data=2 run (conftest's virtual CPU devices) from the
  JAX init, dropout off on both sides, two epochs: training loss within
  1e-3 relative (measured 1e-6 after one epoch, 5e-5 after two: fp32
  summation orders differ and Adam turns the noise on near-zero
  gradients into steps of about lr, so the runs drift apart; one
  process against the JAX trainer's one device drifts as fast, 1.6e-3
  after two epochs and 12% after four), val_acc within one validation
  row.
"""

import os
import sys

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from mec_tpu.config import Config as JaxConfig
from mec_tpu.parallel import mesh as jmesh
from mec_tpu.training import common as jcommon
from mec_tpu.training import train_speech as jax_speech
from mec_tpu_torch import __main__ as cli
from mec_tpu_torch.config import Config
from mec_tpu_torch.parallel import distributed, launch
from mec_tpu_torch.parallel import mesh as pmesh

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_workers as workers  # noqa: E402

SPAWN = dict(devices=['cpu', 'cpu'], threads=1, timeout=240)


def test_initialize_multi_host_plumbing(monkeypatch):
    """Arguments, then MEC_*, then torchrun's variables; False when
    nothing is configured (the counterpart of
    tests/test_parallel.py::test_initialize_multi_host_plumbing)."""
    calls = []
    monkeypatch.setattr(dist, 'is_initialized', lambda: False)
    monkeypatch.setattr(dist, 'init_process_group',
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for var in ('MEC_COORDINATOR_ADDRESS', 'MEC_NUM_PROCESSES',
                'MEC_PROCESS_ID', 'MASTER_ADDR', 'MASTER_PORT', 'RANK',
                'WORLD_SIZE', 'LOCAL_RANK'):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize_multi_host() is False and calls == []
    monkeypatch.setenv('MASTER_ADDR', 'node7')
    monkeypatch.setenv('MASTER_PORT', '29500')
    monkeypatch.setenv('WORLD_SIZE', '8')
    monkeypatch.setenv('RANK', '5')
    assert distributed.initialize_multi_host() is True
    monkeypatch.setenv('MEC_COORDINATOR_ADDRESS', 'host0:1234')
    monkeypatch.setenv('MEC_NUM_PROCESSES', '4')
    monkeypatch.setenv('MEC_PROCESS_ID', '2')
    assert distributed.initialize_multi_host() is True
    assert distributed.initialize_multi_host('h:1', 2, 1,
                                             backend='gloo') is True
    assert calls == [
        ('gloo', dict(init_method='tcp://node7:29500', world_size=8, rank=5)),
        ('gloo', dict(init_method='tcp://host0:1234', world_size=4, rank=2)),
        ('gloo', dict(init_method='tcp://h:1', world_size=2, rank=1))]
    monkeypatch.delenv('MEC_NUM_PROCESSES')
    monkeypatch.delenv('WORLD_SIZE')
    with pytest.raises(ValueError, match='process count'):
        distributed.initialize_multi_host()


@pytest.mark.parametrize('n,data,model', [
    (8, 'auto', 1), (8, 'auto', 2), (8, 'auto', 3), (8, '2', 2),
    (8, '16', 1), (4, '3', 2), (1, 'auto', 4), (6, '0', 4)])
def test_local_mesh_shape_matches_jax(n, data, model, monkeypatch):
    for cfg in (Config, JaxConfig):
        monkeypatch.setattr(cfg, 'MESH_DATA', data)
        monkeypatch.setattr(cfg, 'MESH_MODEL', model)
    assert pmesh.local_mesh_shape(n) == jmesh.local_mesh_shape(n)


def test_the_data_axis_is_never_shrunk():
    """No group, a group of another size, too few GPUs, NCCL on a shared
    GPU: each raises; rows split only evenly."""
    with pytest.raises(RuntimeError, match='none is initialized'):
        pmesh.make_mesh(2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='0 are visible'):
            launch.devices_for(2, 'cuda')
    assert launch.devices_for(3, 'cpu') == ['cpu'] * 3
    with pytest.raises(ValueError, match='NCCL needs one GPU a rank'):
        launch.launch(print, 2, devices=['cuda:0', 'cuda:0'],
                      backend='nccl')
    m = pmesh.DataMesh(rank=1, size=2)
    assert m.shard_rows({'x': np.arange(6)})['x'].tolist() == [3, 4, 5]
    with pytest.raises(ValueError, match='does not split'):
        m.shard_rows({'x': np.arange(5)})
    assert pmesh.active() is None
    with pmesh.data_parallel(m):
        assert pmesh.active() is m
    assert pmesh.active() is None


def test_data_parallel_matches_one_process(tmp_path):
    ranks = launch.launch(workers.dp_checks, 2,
                          args=(str(tmp_path / 'fit.ckpt'),), **SPAWN)
    for name in ('speech', 'fusion', 'moe_bert'):
        ref = workers.one_step(name)
        for got in ranks:
            assert len(got[name]['grads']) == len(ref['grads'])
            for g, r in zip(got[name]['grads'], ref['grads']):
                np.testing.assert_allclose(g, r, atol=1e-10, rtol=0,
                                           err_msg=name)
            for k, r in ref['state'].items():
                np.testing.assert_allclose(got[name]['state'][k], r,
                                           atol=1e-10, rtol=0, err_msg=k)
        mean_loss = (ranks[0][name]['loss'] + ranks[1][name]['loss']) / 2
        assert abs(mean_loss - ref['loss']) <= 1e-10, name
    # the batches: JAX's order, the tail padded as JAX pads under a mesh
    train, _val = workers.fit_data()
    want = []
    for epoch in range(3):
        rng = np.random.RandomState((4 * 1000003 + epoch) % 2**32)
        for b in jcommon.iterate_batches(train, workers.FIT_BATCH, rng):
            padded, _n = jcommon.pad_batch(b, workers.FIT_BATCH)
            want.append(padded['s_feat'][:, 0].astype(int).tolist())
    got = [a + b for a, b in zip(ranks[0]['rows'], ranks[1]['rows'])]
    assert got == want and [len(r) for r in got[:4]] == [8, 8, 8, 8]
    assert want[3][-3:] == [want[3][1]] * 3          # 26 % 8 = 2 real rows
    # identical decisions and parameters on both ranks
    assert ranks[0]['history'] == ranks[1]['history']
    assert all(np.array_equal(a, b) for a, b in
               zip(ranks[0]['params'], ranks[1]['params']))
    assert all(np.array_equal(ranks[0]['best'][k], ranks[1]['best'][k])
               for k in ranks[0]['best'])
    # stopped after 2 epochs and resumed on both ranks from rank 0's
    # checkpoint: where the uninterrupted run ends, bit for bit
    for r in ranks:
        assert r['resumed_history'] == r['history']
        assert all(np.array_equal(a, b) for a, b in
                   zip(r['resumed'], r['params']))


def _speech_xy():
    rng = np.random.RandomState(0)
    y = (np.arange(84) % 7).astype(np.int32)
    X = (rng.randn(84, 56) + y[:, None] * 0.4).astype(np.float32)
    return X, y


def test_train_speech_mesh_data_2_follows_jax(monkeypatch, tmp_path):
    monkeypatch.setattr(fnn.Dropout, '__call__',
                        lambda self, inputs, *a, **k: inputs)
    init = {}
    jax_fit = jcommon.fit

    def spy(state, *a, **k):
        init['params'] = jax.tree.map(np.asarray, state.params)
        init['batch_stats'] = jax.tree.map(np.asarray, state.batch_stats)
        return jax_fit(state, *a, **k)

    monkeypatch.setattr(jcommon, 'fit', spy)
    X, y = _speech_xy()
    _v, _s, want = jax_speech.train(X=X, y=y, epochs=2, batch_size=16,
                                    mesh_data=2, verbose=False,
                                    models_dir=str(tmp_path / 'j'))
    ranks = launch.launch(workers.train_speech_rank, 2,
                          args=(X, y, init, 2, 16, str(tmp_path / 't')),
                          **SPAWN)
    assert ranks[0] == ranks[1]
    got = ranks[0]
    np.testing.assert_allclose(got['loss'], want['loss'], rtol=1e-3)
    np.testing.assert_allclose(got['val_acc'], want['val_acc'], rtol=0,
                               atol=1 / 13 + 1e-9)
    assert sorted(os.listdir(tmp_path / 't')) == ['speech_model.mecp',
                                                  'speech_scaler.npz']


def test_cli_mesh_data_starts_its_ranks(tmp_path, monkeypatch):
    """python -m mec_tpu_torch train-fusion --mesh-data 2 --device cpu
    runs two gloo ranks (one thread each), and rank 0 alone writes;
    --device cuda with fewer visible GPUs than ranks raises naming the
    count."""
    monkeypatch.setenv('OMP_NUM_THREADS', '1')
    out = tmp_path / 'models'
    assert cli.main(['train-fusion', '--mesh-data', '2', '--device', 'cpu',
                     '--num-samples', '64', '--epochs', '1',
                     '--batch-size', '16', '--models-dir', str(out)]) == 0
    assert os.listdir(out) == ['fusion_model.mecp']
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='needs 2 GPUs'):
            cli.main(['train-fusion', '--mesh-data', '2'])
