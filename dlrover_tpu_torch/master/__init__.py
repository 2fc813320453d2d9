"""The job's checkpoint commit coordinator: the port of ``dlrover_tpu/master``
(its ``CkptCommitCoordinator`` only)."""
