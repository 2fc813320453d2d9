"""The job's checkpoint coordination: the port of ``dlrover_tpu/master``'s
``CkptCommitCoordinator`` and ``PeerRestoreBroker`` only."""
