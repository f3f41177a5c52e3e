"""The converters' third-party readers, imported when a conversion runs.

h5py (Keras .h5), joblib (pickled sklearn objects) and safetensors may
be missing where the port runs (the card's machine has neither h5py nor
sklearn nor joblib): a conversion that needs one raises an ImportError
that names the package and the file it was asked to read, as
training/train_fusion_rf.py does for sklearn.
"""

from __future__ import annotations

import importlib


def require(package: str, purpose: str):
    """import_module(package), or ImportError naming it and `purpose`."""
    try:
        return importlib.import_module(package)
    except ImportError as e:
        raise ImportError(f'{purpose} needs the {package} package, which is '
                          f'not installed here: {e}') from e
