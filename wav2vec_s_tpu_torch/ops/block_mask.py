"""Block-attention mask constant (``wav2vec_s_tpu/ops/block_mask.py``).

Masks are additive ``-1e4`` biases, not ``-inf``: a fully masked row stays
finite (reference unidirect_w2v2_encoder.py:155-159).
"""

MASK_VALUE = -1e4
