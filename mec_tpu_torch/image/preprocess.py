"""Image preprocessing for the ResNet50 path.

A copy of mec_tpu/image/preprocess.py (importing mec_tpu imports jax).
The reference serving transform is torchvision Resize((224,224)) ->
ToTensor -> Normalize(ImageNet); PIL's bilinear resize is what
torchvision's Resize does on PIL inputs. The
/255 and mean/std normalization run on the device inside the engine's
image forward, so the host ships uint8 pixels; normalize_uint8 and
load_image_for_model are the host-side variant. PIL is imported only
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


def normalize_uint8(img: np.ndarray) -> np.ndarray:
    """uint8 (…, H, W, 3) -> normalized float32 (host-side variant)."""
    x = img.astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def load_image_for_model(path_or_file, size: Tuple[int, int] = (224, 224),
                         normalized: bool = True) -> np.ndarray:
    """-> (H, W, 3) float32 NHWC, ImageNet-normalized (or raw uint8)."""
    img = load_image_uint8(path_or_file, size)
    return normalize_uint8(img) if normalized else img
