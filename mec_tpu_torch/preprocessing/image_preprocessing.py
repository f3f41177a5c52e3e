"""Image preprocessing: the port of mec_tpu/preprocessing/
image_preprocessing.py, the public API of
reference preprocessing/image_preprocessing.py (Haar-cascade face crop +
resize/normalize).

Note the reference serving path does NOT use these functions (it uses PIL +
torchvision transforms, reference image_inference.py:28-32); they are kept
because they are public API with tests
(reference tests/test_preprocessing.py:119-159). cv2 is an optional
dependency here exactly as librosa/cv2 are soft dependencies in the
reference test suite.
"""

from __future__ import annotations

import numpy as np

from mec_tpu_torch.config import Config


def detect_face(image_path: str):
    """Haar-cascade frontal-face crop with full-image fallback
    (reference image_preprocessing.py:12-23). Returns BGR ndarray or None.

    When the installed OpenCV build lacks the objdetect cascade (e.g.
    minimal cv2 5.x), the no-face-found fallback applies: the full image
    is returned — the same observable behavior the reference exhibits on
    images with no detectable face. Detection is preprocessing-API-only;
    the serving path never crops (reference image_inference.py:28-32)."""
    import cv2
    image = cv2.imread(image_path)
    if image is None:
        return None
    if not hasattr(cv2, 'CascadeClassifier'):
        return image
    try:
        gray = cv2.cvtColor(image, cv2.COLOR_BGR2GRAY)
        cascade = cv2.CascadeClassifier(
            cv2.data.haarcascades + 'haarcascade_frontalface_default.xml')
        faces = cascade.detectMultiScale(gray, 1.3, 5)
    except cv2.error:
        return image
    if len(faces) == 0:
        return image
    x, y, w, h = faces[0]
    return image[y:y + h, x:x + w]


def preprocess_image(image_path: str) -> np.ndarray:
    """-> (1, H, W, 3) float32 in [0, 1]
    (reference image_preprocessing.py:26-33)."""
    import cv2
    face = detect_face(image_path)
    if face is None:
        raise ValueError('Unable to read image file')
    face_resized = cv2.resize(face, Config.IMAGE_SIZE)
    return np.expand_dims(face_resized.astype('float32') / 255.0, axis=0)
