"""Faults planted under the timed path, for the test that a run with one
of them comes out not correct. Each takes the engine before the window
and breaks what predict_multimodal_batch returns."""

import copy


def alter_answer(engine):
    """The first answer of every dispatch altered where it is produced:
    its four probability vectors reversed."""
    batch = engine.predict_multimodal_batch

    def predict_multimodal_batch(requests):
        out = batch(requests)
        for part in out[0].values():
            part['all_probabilities'] = list(
                reversed(part['all_probabilities']))
        return out

    engine.predict_multimodal_batch = predict_multimodal_batch


def half_batch(engine):
    """Half of every dispatch left out: the first half is computed and the
    rest answered with its answers."""
    batch = engine.predict_multimodal_batch

    def predict_multimodal_batch(requests):
        k = (len(requests) + 1) // 2
        out = batch(requests[:k])
        return out + [copy.deepcopy(out[i % k])
                      for i in range(len(requests) - k)]

    engine.predict_multimodal_batch = predict_multimodal_batch
