"""wav2vec_s_tpu_torch — the PyTorch/CUDA port of ``wav2vec_s_tpu``.

A second package beside the JAX one, with the same layout and names so that
each module's counterpart is easy to find.  It imports torch and numpy and
never JAX: the JAX package is the reference the port is tested against.

The first slice is the cached streaming greedy agent (wav2vec-S encoder +
CAAT decoder/jointer), ``stream.batched.CachedFusedGreedyDecoder``.  Its one
hand-written kernel is the incremental chunk attention
(``ops/chunk_attention.py`` + ``csrc/chunk_attention.cu``), built with nvcc
at first use on a CUDA device; on CPU tensors every kernel wrapper runs its
plain PyTorch twin.

Subpackages
-----------
- ``ops``        : the chunk-attention kernel wrapper and its plain twin.
- ``models``     : parameter containers named like the fairseq/rain state
                   dicts (wav2vec-S encoder, CAAT decoder/jointer).
- ``stream``     : incremental encoder, cached CAAT decode steps, the
                   batched greedy decoder.
- ``data``       : the fairseq-format dictionary.
- ``checkpoint`` : JAX parameter tree -> port state dict.
"""

__version__ = "0.1.0"
