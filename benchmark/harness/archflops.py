"""Model FLOPs of the published architectures, counted from their
shapes: a matrix product or a convolution is 2 x its multiply-adds;
elementwise work, normalisations, softmaxes and the forest walk count
nothing."""

from __future__ import annotations

import math

MOBILENET_V2_CFG = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2),
                    (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2),
                    (6, 320, 1, 1))


def conv(cin, cout, k, h_out, w_out, groups=1):
    return 2 * (cin // groups) * cout * k * k * h_out * w_out


def _out(n, k, s, p):
    return (n + 2 * p - k) // s + 1


def image_head(cin: int, classes: int = 7) -> int:
    return 2 * (cin * 512 + 512 * classes)


def resnet50(size: int = 224, classes: int = 7) -> int:
    h = _out(size, 7, 2, 3)
    f = conv(3, 64, 7, h, h)
    h = _out(h, 3, 2, 1)
    cin = 64
    for stage, blocks in enumerate((3, 4, 6, 3)):
        w = 64 * 2 ** stage
        for b in range(blocks):
            s = 2 if (stage and b == 0) else 1
            ho = _out(h, 3, s, 1)
            f += conv(cin, w, 1, h, h) + conv(w, w, 3, ho, ho) \
                + conv(w, 4 * w, 1, ho, ho)
            if b == 0:
                f += conv(cin, 4 * w, 1, ho, ho)
            cin, h = 4 * w, ho
    return f + image_head(cin, classes)


def mobilenet_v2(size: int = 224, classes: int = 7) -> int:
    h = _out(size, 3, 2, 1)
    f = conv(3, 32, 3, h, h)
    cin = 32
    for t, c, n, s in MOBILENET_V2_CFG:
        for i in range(n):
            st = s if i == 0 else 1
            hid = cin * t
            if t != 1:
                f += conv(cin, hid, 1, h, h)
            ho = _out(h, 3, st, 1)
            f += conv(hid, hid, 3, ho, ho, groups=hid)
            f += conv(hid, c, 1, ho, ho)
            cin, h = c, ho
    f += conv(cin, 1280, 1, h, h)
    return f + image_head(1280, classes)


def bert(tokens: int, hidden=768, layers=12, ffn=3072, classes=7) -> int:
    """At the request's own token count, without padding."""
    per_layer = 2 * tokens * (4 * hidden * hidden + 2 * hidden * ffn) \
        + 2 * 2 * tokens * tokens * hidden
    return layers * per_layer + 2 * (hidden * hidden + hidden * classes)


def speech_dnn(dims=(56, 512, 512, 256, 128, 64, 7)) -> int:
    return 2 * sum(a * b for a, b in zip(dims, dims[1:]))


def frontend(frames=130, n_fft=2048, mels=128, mfcc=40, chroma=12) -> int:
    """The rFFT of every frame (2.5 N log2 N a real transform) and the
    mel, DCT and chroma products."""
    bins = n_fft // 2 + 1
    fft = 2.5 * n_fft * math.log2(n_fft)
    return int(frames * (fft + 2 * bins * mels + 2 * mels * mfcc
                         + 2 * bins * chroma))


def attention_fusion(dims=(64, 768, 512), hidden=256, classes=7) -> int:
    h = hidden
    f = sum(2 * d * h for d in dims)                  # projections
    f += 3 * (2 * h * h + 2 * 2 * 2 * h * h           # q; k, v of 2 tokens
              + 2 * 2 * h + 2 * h * h)                # scores+context; out
    f += 3 * 2 * h * h + 2 * 3 * h * h + 2 * h * 3    # pooling
    f += 2 * (3 * classes * 64 + 64 * 3)              # decision MLP
    f += 2 * ((h + classes) * h + h * (h // 2) + (h // 2) * classes)
    return f
