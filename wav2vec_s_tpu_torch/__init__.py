"""wav2vec_s_tpu_torch — the PyTorch/CUDA port of ``wav2vec_s_tpu``.

A second package beside the JAX one, with the same layout and names so that
each module's counterpart is easy to find.  It imports torch and numpy and
never JAX: the JAX package is the reference the port is tested against.

Ported so far: the cached streaming greedy agent (wav2vec-S encoder + CAAT
decoder/jointer), ``stream.batched.CachedFusedGreedyDecoder``, its
corpus-evaluation twin ``stream.batched.OneShotCorpusDecoder`` (one
blockwise encode per utterance, the same greedy loop replayed), and the
CAAT fine-tuning step on dense or flash attention (``W2V2CaatModel.forward``,
``caat_loss``, ``train.recipes.make_caat_loss_fn`` +
``train.step.make_train_step`` + ``train.optim.build_optimizer``, driven by
``train.cli``), the four batched beam decoders (``stream.beam_batched``),
the evaluation entry point ``eval.cli`` (batch decode, DECISION_STEP sweep,
SimulEval-style ``simul``, ``interactive``, ``score``, ``average``,
``eval-lm``), the continuous-batching ``stream.serving.ServingSession``
with the SimulEval agent, server and client, wav2vec-S streaming
pre-training (``Wav2Vec2Model(cfg, pretraining=True)``: span masking, the
Gumbel quantizer, the contrastive head, sampled block contexts;
``train.cli`` with ``run.task=pretrain``) and fairseq ``.pt`` import and
export (``checkpoint.torch_import``, ``torch_export``, ``convert_cli``).
Their
hand-written kernels are the incremental chunk attention
(``ops/chunk_attention.py`` + ``csrc/chunk_attention.cu``), the
block-sparse flash-attention forward (``ops/flash_attention.py`` +
``csrc/flash_attention.cu``), the counter-based dropout (``ops/dropout.py``
+ ``csrc/dropout.cu``) and the transducer lattices and affine rows
(``ops/transducer/kernels.py`` + ``csrc/transducer.cu``), built with nvcc
at first use on a CUDA device; on CPU tensors every kernel wrapper runs its
plain PyTorch twin.

Subpackages
-----------
- ``ops``        : the kernel wrappers and their plain twins, the block
                   layout, the delay-transducer loss, the nvcc build.
- ``models``     : parameter containers named like the fairseq/rain state
                   dicts (wav2vec-S encoder and pre-training heads, CAAT
                   decoder/jointer).
- ``stream``     : incremental encoder, cached CAAT decode steps, the
                   batched greedy and beam decoders, the serving session,
                   the SimulEval agent, server and client, latency metrics.
- ``eval``       : WER, BLEU and the evaluation CLI.
- ``data``       : dictionary, manifests, audio, tokenizers, batching.
- ``train``      : the train step, Adam and adafactor, LR schedules, the
                   pre-training and fine-tuning recipes, the wav2vec
                   criterion, the training CLI.
- ``checkpoint`` : JAX parameter tree -> port state dict; save, restore and
                   averaging of the port's checkpoints; fairseq ``.pt``
                   import, export and the converter.
- ``utils``      : the span masker, positions, progress records.
"""

__version__ = "0.1.0"
