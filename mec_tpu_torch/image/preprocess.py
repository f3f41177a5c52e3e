"""Image preprocessing for the ResNet50 path.

A copy of the part of mec_tpu/image/preprocess.py that serving reads
(importing mec_tpu imports jax). The reference serving transform is
torchvision Resize((224,224)) -> ToTensor -> Normalize(ImageNet); PIL's
bilinear resize is what torchvision's Resize does on PIL inputs. The
/255 and mean/std normalization run on the device inside the engine's
image forward, so the host ships uint8 pixels. PIL is imported only
when a file is decoded: the serving forward itself needs no PIL.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def load_image_uint8(path_or_file, size: Tuple[int, int] = (224, 224)
                     ) -> np.ndarray:
    """Decode + RGB convert + bilinear resize -> (H, W, 3) uint8."""
    from PIL import Image
    img = Image.open(path_or_file).convert('RGB')
    img = img.resize((size[1], size[0]), Image.BILINEAR)
    return np.asarray(img, dtype=np.uint8)
