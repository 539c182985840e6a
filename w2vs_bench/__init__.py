"""The benchmark of ``wav2vec_s_tpu_torch`` on one NVIDIA H100 (``run.py``)."""
