"""Model FLOPs of one tri-modal request of mobilenetv2_bert_rf: the
speech frontend (on the host here, counted all the same: it is the
model's work) and SpeechDNN, BERT-base at the request's real token count,
MobileNetV2 at 224 px; the forest walk counts nothing."""

from benchmark.harness import archflops as a

FIXED = a.frontend() + a.speech_dnn() + a.mobilenet_v2(224)


def request_flops(tokens: int) -> float:
    return float(FIXED + a.bert(tokens))
