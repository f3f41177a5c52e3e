"""Model FLOPs of one tri-modal request of moonlight16b_resnet50_attn: the
speech frontend and SpeechDNN, ResNet50 at 224 px and the attention
fusion at text_dim 2048 (FIXED), and Moonlight-16B-A3B at the request's
real token count: per token and layer MLA's four projections, the dense
SwiGLU of layer 0 or the router, 6 routed and the shared experts, and
attention's scores and context over the request's tokens; the score head
once. Counted from the published shapes (2 x multiply-adds)."""

from benchmark.harness import archflops as a

H, LAYERS, HEADS, NOPE, ROPE, V, LORA = 2048, 27, 16, 128, 64, 128, 512
DENSE, EXPERT, TOP_K, SHARED, EXPERTS, DENSE_LAYERS = (11264, 1408, 6, 2,
                                                       64, 1)

FIXED = (a.frontend() + a.speech_dnn() + a.resnet50(224)
         + a.attention_fusion(dims=(64, H, 512)))

PROJ = 2 * (H * HEADS * (NOPE + ROPE) + H * (LORA + ROPE)
            + LORA * HEADS * (NOPE + V) + HEADS * V * H)
MLP_DENSE = 2 * 3 * H * DENSE
MLP_MOE = 2 * H * EXPERTS + 2 * 3 * H * EXPERT * (TOP_K + SHARED)


def request_flops(tokens: int) -> float:
    attn = 2 * tokens * HEADS * (NOPE + ROPE + V)     # a token's scores, context
    per_token = (LAYERS * (PROJ + attn) + DENSE_LAYERS * MLP_DENSE
                 + (LAYERS - DENSE_LAYERS) * MLP_MOE)
    return float(FIXED + tokens * per_token + 2 * H * 7)
