"""Multi-device and multi-process runs (port of ``dnascent_tpu/parallel``):
device sets and the batch placement rule (``compute``), the gathers that
keep forkSense's and seeBreaks' statistics whole-dataset under sharding
(``collectives``, over ``torch.distributed`` with the gloo backend), the
deterministic merge of shard outputs (``merge``), and process-group set-up,
input sharding, the data-parallel train step and the sequence-sharded CNN
apply (``mesh``)."""
