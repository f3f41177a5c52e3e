"""The reference against the port at tiny sizes on the CPU: the port's
float32 engine (the reference's own parity graph: the rFFT frontend,
live BatchNorm, erf GELU) answers tri-modal requests through
predict_multimodal_batch, and every modality's probabilities agree with
benchmark/reference/ within 1e-4, for both configurations. Then the
precision helpers that make the control."""

import shutil
import tempfile

import numpy as np
import pytest
import torch

from benchmark.harness import check
from benchmark.harness import traffic as tr
from benchmark.harness.cells import Cell
from benchmark.harness.vocab import build_vocab
from benchmark.reference import precision
from benchmark.reference.pipeline import Reference
from benchmark.tests.tiny import make_root
from benchmark.weights.trees import make_trees


@pytest.fixture(scope='module')
def root():
    d = tempfile.mkdtemp(prefix='bench-tiny-')
    yield make_root(d)
    shutil.rmtree(d, ignore_errors=True)


@pytest.mark.parametrize('cell', ['tiny_resnet50_bert_attn.one_client',
                                  'tiny_mobilenetv2_bert_rf.one_client'])
def test_reference_matches_the_port_in_float32(root, cell, tmp_path,
                                               monkeypatch):
    from benchmark import run
    from mec_tpu_torch.config import Config
    c = Cell(cell, root=root)
    cfg = c.config
    monkeypatch.setattr(Config, 'COMPUTE_DTYPE', 'float32')
    monkeypatch.setattr(Config, 'FUSION_MODE', cfg['env']['MEC_FUSION_MODE'])
    torch.manual_seed(0)
    dev = torch.device('cpu')
    vocab, words = build_vocab()
    traffic = tr.build(c.mix, 3, 2.0, words, str(tmp_path), dev)
    engine, batcher = run.build_engine(cfg, make_trees(cfg, 3, dev), vocab,
                                       dev)
    batcher.stop()
    assert engine.compute_dtype == torch.float32
    reqs = traffic.timed[:6]
    answers = engine.predict_multimodal_batch([r.payload() for r in reqs])
    assert all(check.served(a, cfg['fusion']['kind']) for a in answers)
    # float32 serving ships raw RGB: no image wire on either side
    ref = Reference(cfg, make_trees(cfg, 3, dev), vocab, dev,
                    precision.Prec({'image_wire': ['rgb', 'rgb']}, False))
    gaps = check.gaps(answers, ref.run(reqs, answers))
    assert max(gaps.values()) < 1e-4, gaps


def test_trees_repeat_per_seed():
    cfg = Cell('resnet50_bert_attn.one_client').config
    small = dict(cfg, text=dict(cfg['text'], hidden_size=32,
                                num_hidden_layers=1, intermediate_size=64))
    small['fusion'] = dict(cfg['fusion'], text_dim=32)
    a = make_trees(small, 2 ** 31 + 5, 'cpu')
    b = make_trees(small, 2 ** 31 + 5, 'cpu')
    c = make_trees(small, 6, 'cpu')
    k = ('params', 'layer2_0', 'conv2', 'kernel')
    x, y, z = (t['image'][k[0]][k[1]][k[2]][k[3]] for t in (a, b, c))
    assert np.array_equal(x, y) and not np.allclose(x, z)
    # He-normal scale and the zeroed special-token rows
    assert abs(x.std() / np.sqrt(2.0 / (9 * 128)) - 1) < 0.05
    emb = a['text']['params']['word_embeddings']['embedding']
    assert not emb[:5].any() and emb[5:].any()


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.randn(10000)
    r = precision.round_tf32(x)
    assert torch.all((r.view(torch.int32) & 0x1FFF) == 0)
    rel = ((r - x).abs() / x.abs()).max().item()
    assert 2 ** -13 < rel <= 2 ** -11


def test_int4_weights_have_fifteen_levels_a_channel():
    w = torch.randn(64, 8)
    q = precision.quant_sym(w, 4, -1)
    for j in range(8):
        assert len(torch.unique(q[:, j])) <= 15
    p = precision.Prec({'s': ['int8', 'int4']})
    x = torch.randn(4, 64)
    p.calibrating = True
    p.operands(x, w, 's', -1)
    p.calibrating = False
    p.start()
    xq, wq = p.operands(2 * x, w, 's', -1)
    # static: the calibrated range (1.25 x its max) holds 15 levels, and
    # twice the input clips at its ends
    assert len(torch.unique(xq)) <= 15
    assert xq.abs().max() == pytest.approx(1.25 * x.abs().max().item())
    assert torch.equal(wq, q)


def test_exact_reference_changes_nothing():
    table = Cell('resnet50_bert_attn.one_client').config['precision']
    p = precision.Prec(table, control=False)
    x, w = torch.randn(3, 5), torch.randn(5, 2)
    assert torch.equal(p.linear(x, w, None, 'text_int8'), x @ w)
    assert torch.equal(p.wave(x, 'audio_wire'), x)
    assert p.image_wire == 'yuv420'
    assert precision.Prec(table).image_wire == 'yuv420_4bit'


def test_image_wire_matches_the_port():
    """The reference's 8-bit YUV 4:2:0 round trip is the port's wire
    (serving/wire.py) to within a level; at 4 bits it is coarser."""
    from mec_tpu_torch.serving import wire as port_wire
    from benchmark.reference import jpeg
    rgb = torch.randint(0, 256, (2, 6, 8, 3), dtype=torch.uint8)
    y8, uv8 = port_wire.encode_yuv420_np(rgb.numpy())
    port = port_wire.decode_yuv420(torch.from_numpy(y8),
                                   torch.from_numpy(uv8))
    ours = jpeg.wire(rgb, 'yuv420')
    assert (ours - port).abs().max() <= 1.0 + 1e-3
    grey = torch.full((1, 4, 4, 3), 119.0)
    assert torch.allclose(jpeg.wire(grey, 'yuv420_4bit'), grey, atol=1e-3)
    four = jpeg.wire(rgb, 'yuv420_4bit')
    assert (four - rgb.float()).abs().mean() > (ours - rgb.float()).abs().mean()
