"""mec_tpu_torch.utils.roofline (and profiling.device_trace) against the
JAX package's mec_tpu/utils/roofline.py, on the CPU.

The same tanh(a @ b) at 256x256 fp32 goes through JAX's XLA cost model
and the port's dispatch-mode count; the byte and FLOP counts are exact
integers, so they are compared for equality. The chain timers and the
memory probe run here on the CPU (their values are the host's, not a
device's); their arithmetic is pinned with the walls monkeypatched.
"""

import glob
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mec_tpu.utils import roofline as jroofline
from mec_tpu_torch.utils import roofline
from mec_tpu_torch.utils.profiling import device_trace

N = 256
TILE = N * N * 4                         # one 256x256 fp32 array


@pytest.fixture(scope='module')
def both():
    a = np.random.RandomState(0).randn(N, N).astype(np.float32)
    b = np.random.RandomState(1).randn(N, N).astype(np.float32)
    compiled = jax.jit(lambda x, y: jnp.tanh(x @ y)).lower(a, b).compile()
    port = roofline.hbm_traffic_bytes(lambda x, y: torch.tanh(x @ y),
                                      torch.from_numpy(a),
                                      torch.from_numpy(b))
    return jroofline.hbm_traffic_bytes(compiled), port


def test_traffic_args_outputs_and_flops_match_jax(both):
    jax_tr, tr = both
    assert tr['arg_bytes'] == jax_tr['arg_bytes'] == 2 * TILE
    assert tr['out_bytes'] == jax_tr['out_bytes'] == TILE
    # the matmul's 2*N^3; tanh counts no FLOPs in either
    assert tr['flops'] == jax_tr['flops'] == 2 * N ** 3 == 33_554_432


def test_logical_bytes_match_jax_and_bound_the_model(both):
    jax_tr, tr = both
    # the matmul's 3 operands and tanh's 2, 256 KiB each
    assert tr['logical_bytes'] == jax_tr['logical_bytes'] == 5 * TILE \
        == 1_310_720
    assert tr['model_bytes'] == (tr['arg_bytes'] + tr['out_bytes']
                                 + 2 * tr['temp_bytes'])
    assert tr['model_bytes'] <= tr['logical_bytes']


def test_temp_bytes_eager_against_fused(both):
    """Eager torch materializes a @ b before tanh reads it back; XLA
    fuses the two, so its temp arena is empty."""
    jax_tr, tr = both
    assert tr['temp_bytes'] == TILE
    assert jax_tr['temp_bytes'] == 0


def test_traffic_counts_what_the_call_reaches_besides_its_arguments():
    """A module's parameters are read from outside the call like its
    arguments; the Linear's output is a temporary that relu reads."""
    lin = torch.nn.Linear(64, 32)
    x = torch.randn(8, 64)
    with torch.inference_mode():
        tr = roofline.hbm_traffic_bytes(lambda t: torch.relu(lin(t)), x)
    assert tr['arg_bytes'] == (8 * 64 + 64 * 32 + 32) * 4
    assert tr['out_bytes'] == tr['temp_bytes'] == 8 * 32 * 4
    assert tr['flops'] == 2 * 8 * 64 * 32


def test_logical_bytes_count_copies_not_views():
    """reshape and .to(dtype) may return a view of their operand; they
    are counted where they copied (a dtype change, a reshape of a
    non-contiguous slice) and not where they returned a view."""
    x = torch.randn(8, 64, dtype=torch.bfloat16)
    with torch.inference_mode():
        tr = roofline.hbm_traffic_bytes(
            lambda t: t.reshape(64, 8).to(torch.bfloat16).float(), x)
    assert tr['logical_bytes'] == 8 * 64 * (2 + 4)     # the .float() alone
    assert tr['temp_bytes'] == 0 and tr['out_bytes'] == 8 * 64 * 4
    y = torch.randn(8, 66)
    with torch.inference_mode():
        tr = roofline.hbm_traffic_bytes(
            lambda t: t[:, :64].reshape(8, 8, 8).reshape(64, 8), y)
    assert tr['logical_bytes'] == 2 * 8 * 64 * 4        # one copy
    assert tr['out_bytes'] == 8 * 64 * 4


def test_traffic_counts_int8_matmuls_as_operations():
    """torch._int_mm (the port's int8 GEMM) counts as a matmul, which
    FlopCounterMode alone does not."""
    a = torch.ones(32, 64, dtype=torch.int8)
    b = torch.ones(64, 16, dtype=torch.int8)
    tr = roofline.hbm_traffic_bytes(torch._int_mm, a, b)
    assert tr['flops'] == 2 * 32 * 64 * 16
    assert tr['arg_bytes'] == 32 * 64 + 64 * 16
    assert tr['out_bytes'] == 32 * 16 * 4 and tr['temp_bytes'] == 0


def test_chain_slope_cancels_constant_offset(monkeypatch):
    """slope = (wall(k2)-wall(k1))/(k2-k1) removes the constant part of a
    chain's wall (on the card the graph launch and the synchronize)."""
    walls = {40: 29.0 + 40 * 0.5, 160: 29.0 + 160 * 0.5}
    monkeypatch.setattr(roofline, 'chain_wall_ms',
                        lambda call, k, reps=3, device='cuda': walls[k])
    assert roofline.chain_slope_ms(lambda eps: eps) == pytest.approx(0.5)
    assert walls[160] / 160 > 0.68       # the naive single-chain estimate


def test_chain_wall_measures_real_iterations():
    """On the CPU the chain is a plain loop: a longer chain takes longer
    for a real workload, so the slope is positive."""
    x = torch.from_numpy(np.random.RandomState(0).randn(N, N)
                         .astype(np.float32))
    ms = roofline.chain_slope_ms(lambda eps: torch.tanh((x + eps) @ x),
                                 k1=10, k2=40, reps=2, device='cpu')
    assert ms > 0


def test_measure_hbm_gbps_reports_gb_where_jax_reports_gib(monkeypatch):
    """The same two chain walls give the port 2^30 / 10^9 times the JAX
    number: both read size_mb MiB a call, and JAX divides size_mb / 1024
    (GiB/s) where the port divides the bytes by 10^9 (ROADMAP C14)."""
    walls = {40: 31.0, 160: 55.0}                      # ms
    monkeypatch.setattr(roofline, 'chain_wall_ms',
                        lambda call, k, reps=3, device='cuda': walls[k])
    port = roofline.measure_hbm_gbps(size_mb=8, reps=1, device='cpu')
    # JAX times its own inner chain: with reps=1 it reads the clock twice
    # for wall(160), then twice for wall(40) ((wall(k2) - wall(k1)))
    ticks = iter([0.0, walls[160] / 1e3, 0.0, walls[40] / 1e3])
    clock = types.SimpleNamespace(perf_counter=lambda: next(ticks))
    monkeypatch.setattr(jroofline, 'time', clock)
    ref = jroofline.measure_hbm_gbps(size_mb=8, reps=1)
    assert port == pytest.approx(ref * 2 ** 30 / 1e9, rel=1e-12)
    assert port == pytest.approx(8 * 2 ** 20 / 1e9 / (24.0 / 120 * 1e-3),
                                 rel=1e-12)


def test_measure_hbm_gbps_smoke():
    """The probe runs end to end on the CPU and returns a positive,
    finite rate (the host's: the value means something only on a card)."""
    gbps = roofline.measure_hbm_gbps(size_mb=8, reps=1, device='cpu')
    assert np.isfinite(gbps) and gbps > 0


def test_device_trace_writes_a_trace_naming_the_ops(tmp_path):
    a, b = torch.randn(64, 64), torch.randn(64, 64)
    with device_trace(str(tmp_path)):
        torch.tanh(a @ b)
    files = glob.glob(os.path.join(str(tmp_path), '*.pt.trace.json'))
    assert len(files) == 1
    with open(files[0]) as f:
        trace = f.read()
    assert 'aten::mm' in trace and 'aten::tanh' in trace
