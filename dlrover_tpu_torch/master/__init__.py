"""The job master: the local master the launcher spawns (``local_master``,
``main``), its servicer and transports, rendezvous, KV store, data shards,
admission control and metric context, the time-series store of the
heartbeat digests and recovery reports (``timeseries``), and the checkpoint
coordination (``ckpt_coordinator``)."""
