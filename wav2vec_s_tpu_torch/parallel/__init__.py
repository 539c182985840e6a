"""Data, ZeRO-1, FSDP and context parallelism over ``torch.distributed``
(port of ``wav2vec_s_tpu/parallel/``): ``mesh.py`` starts the process
group and lays the ranks out as a (data, seq) ``DeviceMesh``;
``sharding.py`` is the train step's parallel plan (gradient reduction,
FSDP2 units, the ZeRO-1 / FSDP row shards the optimizers update, the
gathers of a checkpoint); ``context.py`` is the time split of the
blockwise encoder under context parallelism; ``functional.py`` holds the
differentiable collectives."""
