"""Data parallelism and multi-rank inference over ``torch.distributed`` —
the counterpart of ``cet_pick_tpu/parallel/`` (``dist``: the process
group, global sums, synced BatchNorm, gradient averaging and batch rows;
``mesh``: starting the ranks of a command)."""
