"""Dataset tooling: Kaggle download helper + raw-dataset organizers.

Copies of mec_tpu/datasets/ (importing mec_tpu imports jax), with
EMOTIONS from this package's config. Parity with reference
download_dataset.py (interactive Kaggle CLI download of Emotions-NLP)
and organize_datasets.py (TESS speech, FER2013 images, Emotions-NLP
text -> datasets/{speech,images,text}).
"""
