"""Multi-process parallelism on ``torch.distributed``: the process launcher,
("data", "model") sharding of DispNet-lite's training step, and batch
evaluation of independent sequence maps."""
