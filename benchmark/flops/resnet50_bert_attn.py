"""Model FLOPs of one tri-modal request of resnet50_bert_attn: the speech
frontend and SpeechDNN, BERT-base at the request's real token count,
ResNet50 at 224 px, the attention fusion."""

from benchmark.harness import archflops as a

FIXED = (a.frontend() + a.speech_dnn() + a.resnet50(224)
         + a.attention_fusion())


def request_flops(tokens: int) -> float:
    return float(FIXED + a.bert(tokens))
