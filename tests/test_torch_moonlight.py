"""Moonlight-16B-A3B's text leg at tiny widths on the CPU: 3 layers (1
dense + 2 expert layers), 16 routed experts, top 6, 2 shared, small MLA
dims, float32, seeded leaves of the benchmark's leg.

The benchmark's float32 reference (benchmark/reference/moonlight.py)
against transformers' DeepseekV3Model on the same weights, then the
port's decoder (models/moonlight.py, its grouped expert GEMM on the
plain path) against the reference, the routing's properties, and the
engine with the leg. Tolerances, each with its reason: the reference and
DeepseekV3Model 1e-5 (float32 sums in other orders: the experts added
per token in another order, RoPE on deepseek's permuted pairs); the port
and the reference 2e-5 (the same, and the shared SwiGLU summed as two
1-expert halves of the grouped GEMM, the pairs summed in slot order).

The expert layer's entry point is held bit for bit to the composition
its kernels replaced (its wrappers' plain versions on the CPU). The card
tests (marker cuda; they skip here) run the grouped GEMM, the router, the
sort and the combine against their plain versions at the serving shapes,
and a captured expert layer against eager:

    python -m pytest --noconftest -m cuda tests/test_torch_moonlight.py -q
"""

import copy

import numpy as np
import pytest
import torch

from benchmark.legs import text_moonlight as leg
from benchmark.reference import moonlight as reference
from benchmark.reference.precision import Prec
from benchmark.weights import seeded
from mec_tpu_torch.models.moonlight import MoonlightForClassification
from mec_tpu_torch.ops import expert_gemm

TEXT = dict(leg.TINY, n_shared_experts=2, num_experts_per_tok=6,
            first_k_dense_replace=1, rope_theta=50000.0, rms_norm_eps=1e-5,
            routed_scaling_factor=2.446, norm_topk_prob=True, num_labels=7,
            embedding_rows=1000)
REF_TOL, PORT_TOL = 1e-5, 2e-5


def _tree(seed=2 ** 31 + 5, text=TEXT):
    return seeded.materialize(seeded.bind(leg.plan(None, **text), seed,
                                          'cpu'))


def _inputs(B=3, L=16, seed=0):
    """Right-padded ids, the rows' real lengths 16, 11 and 5."""
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(5, TEXT['embedding_rows'], (B, L), generator=g)
    lengths = torch.tensor([L, 11, 5][:B])
    mask = (torch.arange(L)[None] < lengths[:, None]).to(torch.int32)
    return ids * mask, mask


def _ref(tree, ids, mask, text=TEXT):
    with torch.no_grad():
        return reference.forward(tree, ids, mask, text,
                                 Prec(None, control=False))


def _port(tree, ids, mask, text=TEXT):
    with torch.no_grad():
        logits, feat, _n = MoonlightForClassification(tree, text)(ids, mask)
    return torch.softmax(logits, -1), feat


@pytest.fixture(scope='module')
def tree():
    return _tree()


def test_reference_equals_transformers_deepseek_v3(tree):
    tf = pytest.importorskip('transformers')
    cfg = tf.DeepseekV3Config(
        vocab_size=TEXT['embedding_rows'], hidden_size=TEXT['hidden_size'],
        intermediate_size=TEXT['intermediate_size'],
        moe_intermediate_size=TEXT['moe_intermediate_size'],
        num_hidden_layers=TEXT['num_hidden_layers'],
        num_attention_heads=TEXT['num_attention_heads'],
        num_key_value_heads=TEXT['num_attention_heads'],
        n_shared_experts=2, n_routed_experts=TEXT['n_routed_experts'],
        routed_scaling_factor=2.446, kv_lora_rank=TEXT['kv_lora_rank'],
        q_lora_rank=None, qk_rope_head_dim=TEXT['qk_rope_head_dim'],
        v_head_dim=TEXT['v_head_dim'],
        qk_nope_head_dim=TEXT['qk_nope_head_dim'], n_group=1, topk_group=1,
        num_experts_per_tok=6, first_k_dense_replace=1, norm_topk_prob=True,
        rope_theta=50000.0, rms_norm_eps=1e-5, rope_interleave=True,
        rope_scaling=None, max_position_embeddings=256,
        attention_bias=False, attn_implementation='eager')
    model = tf.DeepseekV3Model(cfg).eval()
    state = {}
    for path, v in _flat(tree):
        if path.startswith(('score', )):
            continue
        if '.mlp.experts.' in path:
            head, name = path.rsplit('.', 1)
            for e in range(v.shape[0]):
                state[f'{head}.{e}.{name}.weight'] = v[e]
        else:
            state[path] = v
    missing, unexpected = model.load_state_dict(state, strict=False)
    assert not unexpected and not missing, (missing, unexpected)
    ids, mask = _inputs()
    with torch.no_grad():
        hidden = model(input_ids=ids, attention_mask=mask).last_hidden_state
    last = mask.sum(1) - 1
    want = hidden[torch.arange(3), last]
    probs, feat = _ref(tree, ids, mask)
    assert torch.allclose(feat, want, atol=REF_TOL, rtol=0)
    want_p = torch.softmax(want @ tree['score']['weight'].T, -1)
    assert torch.allclose(probs, want_p, atol=REF_TOL, rtol=0)


def _flat(tree, path=''):
    for k, v in tree.items():
        p = f'{path}.{k}' if path else k
        if isinstance(v, dict):
            yield from _flat(v, p)
        else:
            yield p, v


def test_port_decoder_equals_the_reference(tree):
    ids, mask = _inputs()
    probs, feat = _port(tree, ids, mask)
    r_probs, r_feat = _ref(tree, ids, mask)
    assert torch.allclose(feat, r_feat, atol=PORT_TOL, rtol=0)
    assert torch.allclose(probs, r_probs, atol=PORT_TOL, rtol=0)


@pytest.mark.parametrize('bucket', [32, 128])
def test_logits_do_not_depend_on_the_sequence_bucket(tree, bucket):
    ids, mask = _inputs(L=16)
    pad = bucket - 16
    wide_ids = torch.nn.functional.pad(ids, (0, pad), value=7)
    wide_mask = torch.nn.functional.pad(mask, (0, pad))
    probs, feat = _port(tree, ids, mask)
    w_probs, w_feat = _port(tree, wide_ids, wide_mask)
    assert torch.allclose(w_feat, feat, atol=1e-5, rtol=0)
    assert torch.allclose(w_probs, probs, atol=1e-6, rtol=0)


def _routing_case(T=10, valid_n=7, seed=0):
    g = torch.Generator().manual_seed(seed)
    E = TEXT['n_routed_experts']
    idx = torch.stack([torch.randperm(E, generator=g)[:6] for _ in range(T)])
    w = torch.rand(T, 6, generator=g)
    valid = torch.arange(T) < valid_n
    return idx, w, valid


def test_padding_rows_reach_no_expert():
    idx, w, valid = _routing_case()
    E, S = TEXT['n_routed_experts'], 2
    r = expert_gemm.route(idx, w, valid, E, S)
    real = int(valid.sum())
    assert int(r.offsets[-1]) == real * (6 + S)
    assert r.src[:real * (6 + S)].max() < real
    assert int(r.counts[E + S]) == (len(valid) - real) * (6 + S)
    # a NaN in every padding token's row reaches no product
    g = torch.Generator().manual_seed(1)
    H, Im = 64, 32
    x = torch.randn(len(valid), H, generator=g)
    weights = _expert_weights(E, S, H, Im, g)
    y = expert_gemm.combine(expert_gemm.grouped_expert_gemm(
        x, r, *weights), r, valid)
    x[~valid] = float('nan')
    y_nan = expert_gemm.combine(expert_gemm.grouped_expert_gemm(
        x, r, *weights), r, valid)
    assert torch.equal(y, y_nan)
    assert torch.all(y[~valid] == 0)


def _expert_weights(E, S, H, Im, g):
    def w(*shape):
        return torch.randn(*shape, generator=g) * 0.1
    return (w(E, Im, H), w(E, Im, H), w(E, H, Im), w(S * Im, H),
            w(S * Im, H), w(H, S * Im))


@pytest.mark.parametrize('case', ['some_experts_empty', 'one_row_each',
                                  'every_row_one_expert'])
def test_grouped_gemm_plain_equals_a_per_expert_loop(case):
    E, S, H, Im, T = 8, 2, 64, 32, 12
    g = torch.Generator().manual_seed(3)
    x = torch.randn(T, H, generator=g)
    if case == 'some_experts_empty':       # experts 4-7 get no row
        idx = torch.stack([torch.randperm(4, generator=g)[:2]
                           for _ in range(T)])
    elif case == 'one_row_each':           # each expert one row
        idx = torch.arange(E)[:, None][:T]
        x = x[:E]
        T = E
    else:                                  # expert 3 takes every token
        idx = torch.full((T, 1), 3)
    w = torch.rand(T, idx.shape[1], generator=g)
    valid = torch.ones(T, dtype=torch.bool)
    weights = _expert_weights(E, S, H, Im, g)
    r = expert_gemm.route(idx, w, valid, E, S)
    got = expert_gemm.combine(expert_gemm.grouped_expert_gemm(
        x, r, *weights), r, valid)
    gate, up, down, gate_s, up_s, down_s = weights
    want = torch.zeros(T, H)
    for t in range(T):
        for j, e in enumerate(idx[t].tolist()):
            h = torch.nn.functional.silu(gate[e] @ x[t]) * (up[e] @ x[t])
            want[t] += w[t, j] * (down[e] @ h)
        h = torch.nn.functional.silu(gate_s @ x[t]) * (up_s @ x[t])
        want[t] += down_s @ h
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)
    counts = r.counts[:E].tolist()
    assert counts == [int((idx == e).sum()) for e in range(E)]


def _capture_routes(monkeypatch):
    seen = []
    route = expert_gemm.route

    def spy(idx, w, valid, n_routed, n_shared):
        seen.append((idx.clone(), w.clone()))
        return route(idx, w, valid, n_routed, n_shared)
    monkeypatch.setattr(expert_gemm, 'route', spy)
    return seen


def _with_bias(tree, fn):
    t = copy.deepcopy(tree)
    for i in range(1, TEXT['num_hidden_layers']):
        gate = t['layers'][str(i)]['mlp']['gate']
        gate['e_score_correction_bias'] = fn(gate['e_score_correction_bias'])
    return t


def test_the_correction_bias_chooses_and_never_weights(tree, monkeypatch):
    ids, mask = _inputs()
    seen = _capture_routes(monkeypatch)
    probs, _f = _port(tree, ids, mask)
    base = list(seen)
    seen.clear()
    _port(_with_bias(tree, torch.zeros_like), ids, mask)
    assert any(not torch.equal(a[0].sort(-1).values, b[0].sort(-1).values)
               for a, b in zip(base, seen))
    # the same shift for every expert chooses the same experts, and the
    # weights (and so the answer) do not move: the bias never weights
    seen.clear()
    shifted, _f = _port(_with_bias(tree, lambda b: b + 0.3), ids, mask)
    for (i0, w0), (i1, w1) in zip(base, seen):
        assert torch.equal(i0, i1) and torch.equal(w0, w1)
    assert torch.equal(shifted, probs)


@pytest.mark.parametrize('drop', ['shared_experts', 'routed_scale',
                                  'normalisation'])
def test_each_term_of_the_expert_layer_is_checked(tree, drop):
    """A decoder without one term fails the comparison with the reference
    by far more than its tolerance."""
    ids, mask = _inputs()
    text, t = dict(TEXT), tree
    if drop == 'shared_experts':
        t = copy.deepcopy(tree)
        for i in range(1, TEXT['num_hidden_layers']):
            sh = t['layers'][str(i)]['mlp']['shared_experts']
            sh['down_proj']['weight'] = torch.zeros_like(
                sh['down_proj']['weight'])
    elif drop == 'routed_scale':
        text['routed_scaling_factor'] = 1.0
    else:
        text['norm_topk_prob'] = False
    _p, feat = _port(t, ids, mask, text)
    _rp, r_feat = _ref(tree, ids, mask)
    assert (feat - r_feat).abs().max() > 100 * PORT_TOL


def _old_expert_layer(x, p, valid, text=TEXT):
    """The expert layer as the decoder composed it before its glue became
    kernels: rms_norm, the float32 gate, topk, route(), the grouped GEMM,
    combine() and the add, with the counters summed beside."""
    from mec_tpu_torch.models.moonlight import rms_norm
    mlp, gate = p['mlp'], p['mlp']['gate']
    h = rms_norm(x, p['post_attention_layernorm']['weight'],
                 text['rms_norm_eps'])
    scores = torch.sigmoid(h.float() @ gate['weight'].float().T)
    choice = scores + gate['e_score_correction_bias'].float()
    idx = torch.topk(choice, text['num_experts_per_tok'], -1).indices
    w = scores.gather(1, idx)
    w = w / (w.sum(-1, keepdim=True) + 1e-20)
    w = w * text['routed_scaling_factor']
    E = text['n_routed_experts']
    r = expert_gemm.route(idx, w, valid, E, text['n_shared_experts'])
    ex, sh = mlp['experts'], mlp['shared_experts']
    y = expert_gemm.grouped_expert_gemm(
        h, r, ex['gate_proj'], ex['up_proj'], ex['down_proj'],
        sh['gate_proj']['weight'], sh['up_proj']['weight'],
        sh['down_proj']['weight'])
    per = r.counts[:E]
    counts = torch.stack([(per > 0).sum(), per.sum()]).to(torch.int32)
    out = torch.where(valid[:, None], y[r.pos].sum(1), 0.0)
    return x + out.to(x.dtype), counts


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('bucket', [16, 32, 128])
def test_the_expert_layer_equals_the_old_composition(tree, bucket, dtype):
    """The expert layer's entry point on the CPU (its wrappers' plain
    versions) against the composition it replaced, bit for bit, with
    padding tokens (real lengths 16, 11 and 5) at every sequence bucket."""
    dt = getattr(torch, dtype)
    t = _flat_map(tree, lambda v: v.to(dt))
    _ids, mask = _inputs()
    mask = torch.nn.functional.pad(mask, (0, bucket - 16))
    valid = mask.reshape(-1) > 0
    g = torch.Generator().manual_seed(bucket)
    x = torch.randn(valid.numel(), TEXT['hidden_size'], generator=g).to(dt)
    model = MoonlightForClassification(t, TEXT)
    for layer in range(1, TEXT['num_hidden_layers']):
        p = t['layers'][str(layer)]
        counts = torch.ones(2, dtype=torch.int32)
        got = model.expert_layer(x, p, valid, counts)
        want, n = _old_expert_layer(x, p, valid)
        assert got.dtype == dt and torch.equal(got, want)
        assert torch.equal(counts, n + 1)
        assert torch.equal(got[~valid], x[~valid])
        x = got


def test_the_router_covers_every_captured_shape_in_one_wave():
    """The router's tokens a block follow the step's tokens: at each of the
    nine captured (batch, sequence) shapes its grid fits the SMs once and
    its shared memory fits a block at Moonlight's width."""
    H = 2048
    for B in (1, 8, 32):
        for L in (16, 32, 128):
            T = B * L
            tb = expert_gemm.router_tokens(T)
            assert tb in (4, 8, 16, 32)
            assert -(-T // tb) <= expert_gemm._build.SM_COUNT
            assert tb * H * 2 + 2 * tb * 64 * 4 <= expert_gemm.MAX_SMEM
    assert expert_gemm.router_tokens(16) == 4
    assert expert_gemm.router_tokens(4096) == 32


def _tiny_engine(tree, device='cpu', dtype='float32'):
    from mec_tpu_torch.serving import synthetic_artifacts as sa
    from mec_tpu_torch.serving.engine import EmotionEngine
    dt = getattr(torch, dtype)
    text_tree = {k: v for k, v in _flat_map(tree, lambda v: v.to(device, dt))
                 .items()}
    img, meta = sa.image_variables(1, image_size=32)
    return EmotionEngine(
        sa.speech_variables(0), None, image_variables=img,
        image_meta=meta, text_arch='moonlight', text_variables=text_tree,
        text_kwargs=dict(TEXT), text_vocab=sa.make_vocab(),
        fusion_variables=sa.fusion_variables(
            3, text_dim=TEXT['hidden_size']),
        fusion_config=dict(text_dim=TEXT['hidden_size']),
        compute_dtype=dtype, device=device)


def _flat_map(tree, fn):
    return {k: (_flat_map(v, fn) if isinstance(v, dict) else fn(v))
            for k, v in tree.items()}


def _requests(n=3, seed=0):
    rng = np.random.RandomState(seed)
    from mec_tpu_torch.ops import audio_features as af
    texts = ['i feel so happy today', 'the storm was terrible and sad',
             'calm sea']
    return [{'audio_path': 'a.wav', 'text': texts[i % 3],
             'image_path': 'i.jpg',
             'wave': (0.1 * rng.randn(af.N_SAMPLES)).astype(np.float32),
             'image': rng.randint(0, 256, (32, 32, 3)).astype(np.uint8)}
            for i in range(n)]


def test_the_engine_serves_the_leg_as_the_eager_composition(tree):
    from mec_tpu_torch.utils.profiling import timer
    eng = _tiny_engine(tree)
    assert eng._all_live and eng.text_leg is not None and eng.bert is None
    reqs = _requests()
    timer.reset()
    got = eng.predict_multimodal_batch(reqs)
    counts = timer.summary()
    assert counts['text.moe.routed_pairs']['count'] == 1
    assert 0 < counts['text.moe.experts_touched']['p50_ms'] <= 16
    waves = np.stack([r['wave'] for r in reqs])
    imgs = np.stack([r['image'] for r in reqs])
    s = eng.predict_speech_waves(waves, want_features=True)
    t = eng.predict_texts([r['text'] for r in reqs], want_features=True)
    i = eng.predict_images(imgs, want_features=True)
    for j, ans in enumerate(got):
        fused = eng.fuse_attention(
            s[j]['_features'], t[j]['_features'], i[j]['_features'],
            s[j]['all_probabilities'], t[j]['all_probabilities'],
            i[j]['all_probabilities'])
        for k, want in (('speech', s[j]), ('text', t[j]), ('image', i[j]),
                        ('fusion', fused)):
            np.testing.assert_allclose(ans[k]['all_probabilities'],
                                       want['all_probabilities'], atol=1e-5)
    # the text route is the decoder's own answer
    ids, mask = eng._text_wire([reqs[0]['text']], 1)
    probs, _f = _port(tree, torch.as_tensor(ids), torch.as_tensor(mask))
    np.testing.assert_allclose(t[0]['all_probabilities'], probs[0].numpy(),
                               atol=1e-6)


@pytest.mark.parametrize('kw', [dict(text_arch='gpt'),
                                dict(text_arch='bert', text_variables={})])
def test_the_text_keywords_name_the_moonlight_leg_only(kw):
    """text_variables are the Moonlight leg's: BERT takes bert_* alone, and
    an unknown architecture is refused."""
    from mec_tpu_torch.serving.engine import EmotionEngine
    with pytest.raises(ValueError):
        EmotionEngine(device='cpu', **kw)


# ------------------------------------------------------------------ card
@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the grouped expert GEMM runs only '
                    'there')
    return torch.device('cuda')


FULL = dict(H=2048, I=1408, E=64, S=2, K=6)


@pytest.fixture(scope='module')
def full_weights():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    g = torch.Generator(device='cuda').manual_seed(0)
    H, Im, E, S = FULL['H'], FULL['I'], FULL['E'], FULL['S']

    def w(*shape):
        return (torch.randn(*shape, generator=g, device='cuda')
                * 0.02).to(torch.bfloat16)
    return (w(E, Im, H), w(E, Im, H), w(E, H, Im), w(S * Im, H),
            w(S * Im, H), w(H, S * Im))


def _full_routing(B, L, real, seed=0):
    g = torch.Generator(device='cuda').manual_seed(seed)
    T = B * L
    x = torch.randn(T, FULL['H'], generator=g, device='cuda').to(
        torch.bfloat16)
    valid = (torch.arange(L, device='cuda') < real).repeat(B)
    idx = torch.topk(torch.rand(T, FULL['E'], generator=g, device='cuda'),
                     FULL['K'], -1).indices
    w = torch.rand(T, FULL['K'], generator=g, device='cuda')
    return x, valid, expert_gemm.route(idx, w, valid, FULL['E'], FULL['S'])


@pytest.mark.cuda
@pytest.mark.parametrize('B,L,real', [(1, 16, 12), (1, 32, 30),
                                      (1, 128, 100), (32, 128, 128)])
def test_kernel_equals_its_plain_version(dev, full_weights, B, L, real):
    """h rounds to bf16 in both, after float32 sums that run in other
    orders, so an h element near a rounding boundary lands one bf16 ulp
    (2^-8 of it) apart, and down sums 1,408 of them: 5e-3 of the
    outputs' largest magnitude (2-7 here; the widest gap read 2.6e-3 of
    it, at b32 x 128)."""
    x, valid, r = _full_routing(B, L, real)
    before = expert_gemm.grouped_expert_gemm.launches
    y = expert_gemm.grouped_expert_gemm(x, r, *full_weights)
    torch.cuda.synchronize()
    assert expert_gemm.grouped_expert_gemm.launches == before + 1
    want = expert_gemm.grouped_expert_gemm_plain(x, r, *full_weights)
    n = int(r.offsets[-1])
    assert n == int(valid.sum()) * (FULL['K'] + FULL['S'])
    err = (y[:n] - want[:n]).abs().max().item()
    assert err <= 5e-3 * want[:n].abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize('B,L,real', [(1, 16, 12), (32, 128, 128)])
def test_a_captured_expert_layer_replays_eager_bit_for_bit(dev, full_weights,
                                                           B, L, real):
    x, valid, _r = _full_routing(B, L, real)
    g = torch.Generator(device='cuda').manual_seed(5)
    scores = torch.rand(B * L, FULL['E'], generator=g, device='cuda')

    def layer():
        idx = torch.topk(scores, FULL['K'], -1).indices
        w = scores.gather(1, idx)
        r = expert_gemm.route(idx, w, valid, FULL['E'], FULL['S'])
        return expert_gemm.combine(expert_gemm.grouped_expert_gemm(
            x, r, *full_weights), r, valid)
    eager = layer()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = layer()
    scores.copy_(torch.rand(B * L, FULL['E'], generator=g, device='cuda'))
    eager2 = layer()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(static, eager2)
    assert not torch.equal(eager, eager2)


def _glue_inputs(B, L, real, seed=0):
    """x (T, H) bf16 at the residual stream's scale, the post-attention
    norm, the gate at deepseek_v3's init and a correction bias in
    [-0.01, 0.01] (benchmark/legs/text_moonlight.py), and the valid
    tokens: rows of `real` tokens at b1, of `real` less 7 b (mod `real`)
    at b > 1, so that padding sits between real tokens."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    H, E = FULL['H'], FULL['E']
    x = (torch.randn(B * L, H, generator=g, device='cuda')
         * 3).to(torch.bfloat16)
    norm_w = (1 + 0.1 * torch.randn(H, generator=g, device='cuda')).to(
        torch.bfloat16)
    gate_w = (0.02 * torch.randn(E, H, generator=g, device='cuda')).to(
        torch.bfloat16)
    bias = (0.02 * torch.rand(E, generator=g, device='cuda') - 0.01).to(
        torch.bfloat16)
    lengths = torch.tensor([real - (7 * b) % real for b in range(B)],
                           device='cuda')
    valid = (torch.arange(L, device='cuda')[None] < lengths[:, None]
             ).reshape(-1)
    return x, (norm_w, gate_w, bias), valid


ROUTER_ARGS = dict(eps=1e-5, k=FULL['K'], norm_topk_prob=True, scale=2.446)
# the rsqrt's float32 ulps within which each row of the router's h must be
# rms_norm's row exactly: the mean of squares sums in another order
H_ULPS = 8


def _h_at_a_nearby_rsqrt(x, norm_w, h, eps=ROUTER_ARGS['eps'], ulps=H_ULPS):
    """Whether each row of h is exactly models/moonlight.py::rms_norm's row
    at an rsqrt within `ulps` float32 ulps of torch's. (A bound in bf16
    ulps of h would be two, not one: the normalised row rounds to bf16,
    and its product with the weight rounds again.)"""
    xf = x.float()
    r = torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    ok = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    lo, hi = r, r
    for _ in range(ulps + 1):
        for rr in (lo, hi):
            ok |= (norm_w * (xf * rr).to(x.dtype) == h).all(-1)
        lo = torch.nextafter(lo, torch.full_like(lo, -float('inf')))
        hi = torch.nextafter(hi, torch.full_like(hi, float('inf')))
    return ok


def _router(x, weights, plain=False):
    fn = expert_gemm.expert_router_plain if plain else expert_gemm.expert_router
    return fn(x, *weights, **ROUTER_ARGS)


@pytest.mark.cuda
@pytest.mark.parametrize('B,L,real', [(1, 16, 12), (1, 32, 30),
                                      (1, 128, 100), (32, 128, 128)])
def test_router_equals_its_plain_version(dev, B, L, real):
    """h rms_norm's exactly at an rsqrt a few float32 ulps from torch's
    (the mean of squares sums in another order); the choice equal to topk of the float32 scores of the
    kernel's own h, in order, but where two neighbours of a token's top 7
    biased scores lie within 1e-5 relative (float32 sums of 2,048 products
    in another order than cuBLAS's); the weights within 1e-6 relative
    (the sum of six scores in another order)."""
    x, weights, _valid = _glue_inputs(B, L, real)
    before = expert_gemm.expert_router.launches
    h, idx, w = _router(x, weights)
    torch.cuda.synchronize()
    assert expert_gemm.expert_router.launches == before + 1
    ph, _pidx, _pw = _router(x, weights, plain=True)
    assert _h_at_a_nearby_rsqrt(x, weights[0], h).all()
    assert (h == ph).float().mean() > 0.99
    _norm_w, gate_w, bias = weights
    scores = torch.sigmoid(h.float() @ gate_w.float().T)
    top = torch.topk(scores + bias.float(), FULL['K'] + 1, -1)
    gaps = top.values[:, :-1] - top.values[:, 1:]
    near = (gaps <= 1e-5 * top.values[:, 1:].abs()).any(-1)
    assert near.float().mean() < 0.01
    want = top.indices[:, :FULL['K']]
    assert torch.equal(idx.long()[~near], want[~near])
    s = scores.gather(1, want)
    want_w = s / (s.sum(-1, keepdim=True) + 1e-20) * ROUTER_ARGS['scale']
    rel = ((w - want_w).abs() / want_w.abs())[~near]
    assert rel.max().item() <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize('B,L,real', [(1, 16, 12), (1, 32, 30),
                                      (1, 128, 100), (32, 128, 128)])
def test_sort_and_combine_equal_their_plain_versions(dev, full_weights, B, L,
                                                     real):
    """The sort writes route()'s Routing exactly for the router's choice,
    and its counters; the combine (x + the bf16 sum of a token's pairs in
    slot order) is bit for bit with combine() and the add on the same y,
    padding tokens keeping x."""
    x, weights, valid = _glue_inputs(B, L, real)
    _h, idx, w = _router(x, weights)
    E, S = FULL['E'], FULL['S']
    counters = torch.tensor([3, 5], dtype=torch.int32, device='cuda')
    want_counters = counters.clone()
    before = expert_gemm.sort_pairs.launches
    r = expert_gemm.sort_pairs(idx, w, valid, E, S, counters)
    torch.cuda.synchronize()
    assert expert_gemm.sort_pairs.launches == before + 1
    want = expert_gemm.route(idx.long(), w, valid, E, S)
    for name in want._fields:
        assert torch.equal(getattr(r, name), getattr(want, name)), name
    per = want.counts[:E]
    want_counters += torch.stack([(per > 0).sum(), per.sum()]).int()
    assert torch.equal(counters, want_counters)
    g = torch.Generator(device='cuda').manual_seed(1)
    y = torch.randn(r.src.numel(), FULL['H'], generator=g, device='cuda')
    y[int(r.offsets[-1]):] = float('nan')     # padding pairs' rows
    before = expert_gemm.combine_residual.launches
    got = expert_gemm.combine_residual(x, y, r, valid)
    torch.cuda.synchronize()
    assert expert_gemm.combine_residual.launches == before + 1
    plain = x + expert_gemm.combine(y, r, valid).to(x.dtype)
    assert torch.equal(got, plain)
    assert torch.equal(got[~valid], x[~valid])


@pytest.mark.cuda
@pytest.mark.parametrize('B,L,real', [(1, 16, 12), (32, 128, 128)])
def test_a_captured_whole_expert_layer_replays_eager_bit_for_bit(
        dev, full_weights, B, L, real):
    """Router, sort, grouped GEMM and combine captured into one CUDA graph:
    a replay on new tokens equals eager on them bit for bit, counters
    included, and each wrapper's .launches rises by its captured calls on
    a replay (one each)."""
    from mec_tpu_torch.ops import _build
    x, weights, valid = _glue_inputs(B, L, real)
    counters = torch.zeros(2, dtype=torch.int32, device='cuda')
    wrappers = (expert_gemm.expert_router, expert_gemm.sort_pairs,
                expert_gemm.grouped_expert_gemm, expert_gemm.combine_residual)

    def layer():
        counters.zero_()
        _h, idx, w = _router(x, weights)
        r = expert_gemm.sort_pairs(idx, w, valid, FULL['E'], FULL['S'],
                                   counters)
        y = expert_gemm.grouped_expert_gemm(_h, r, *full_weights)
        return expert_gemm.combine_residual(x, y, r, valid)
    eager = layer()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with _build.counting_calls() as calls, torch.cuda.graph(graph):
        static = layer()
    assert all(calls[wr] == 1 for wr in wrappers), calls
    x2, _w, _v = _glue_inputs(B, L, real, seed=9)
    x.copy_(x2)
    eager2 = layer()
    eager_counters = counters.clone()
    before = [wr.launches for wr in wrappers]
    graph.replay()
    _build.add_launches(calls)
    torch.cuda.synchronize()
    assert [wr.launches for wr in wrappers] == [n + 1 for n in before]
    assert torch.equal(static, eager2)
    assert torch.equal(counters, eager_counters)
    assert not torch.equal(eager, eager2)
