"""The grouped expert GEMM (csrc/grouped_expert_gemm.cu) of Moonlight-16B-
A3B's 26 expert layers, one step: two launches a layer (gate and up with
SwiGLU; down with the routing weight). Each real token makes 6 routed
pairs and 2 with the shared experts, which run as two more groups of the
same launches. Bytes, a layer: the bf16 weights of every touched routed
expert and of the two shared ones (3 x 2048 x 1408 each), the pairs' rows
in (x, 2048 bf16) and out (h, 1408 bf16), h read again by down and its
float32 output (2048) written. Operations: 2 x 3 x 2048 x 1408 a pair on
the bf16 tensor cores.

bound_ms(batch) is what the step's readers call; the routing counts the
program records a dispatch (text.moe.experts_touched and
text.moe.routed_pairs, means over the layers) replace its assumption of
16 tokens a request where they are given.

The program counts the wrapper's calls in mec_tpu_torch.ops.expert_gemm;
COUNTER names PROGRAM below, which reads that count where the program
has the module and 0 where it has not (an older checkout), so that a
traced run of any cell imports it."""

from benchmark.harness.peaks import bound_ms as _bound

GLOBALS = ('grouped_expert_kernel',)
COUNTER = ('benchmark.bounds.grouped_expert_gemm', 'PROGRAM')
LAUNCHES = 2
HIDDEN, INTER, EXPERTS, SHARED, TOP_K, LAYERS = 2048, 1408, 64, 2, 6, 26


class _ProgramCount:
    @property
    def launches(self) -> int:
        try:
            from mec_tpu_torch.ops.expert_gemm import grouped_expert_gemm
        except ImportError:
            return 0
        return grouped_expert_gemm.launches


PROGRAM = _ProgramCount()


def bound_ms(batch: int, experts_touched: float = None,
             routed_pairs: float = None, tokens: int = 16) -> float:
    """The least time of one step's launches (all LAYERS layers) at a
    batch of `batch` requests: routed_pairs and experts_touched a layer
    as the program counted them, else `tokens` real tokens a request and
    the touched experts expected of uniform routing."""
    pairs = batch * tokens * TOP_K if routed_pairs is None else routed_pairs
    real = pairs / TOP_K
    if experts_touched is None:
        experts_touched = EXPERTS * (1 - (1 - TOP_K / EXPERTS) ** real)
    rows = pairs + SHARED * real
    weights = (experts_touched + SHARED) * 3 * HIDDEN * INTER * 2
    moved = weights + rows * (HIDDEN * 2 + 2 * INTER * 2 + HIDDEN * 4)
    return _bound(LAYERS * moved, LAYERS * 2 * 3 * HIDDEN * INTER * rows,
                  'bf16_tc')[0]
