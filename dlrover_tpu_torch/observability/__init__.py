"""The rank's runtime digest: what one worker process measures of itself.

Port of ``dlrover_tpu/observability``'s worker-side modules:

* ``metrics``: the RED registry and its Prometheus text;
* ``trace``: spans with trace ids, a span sink, ``record_function``;
* ``flight_recorder``: bounded rings of spans, events and step times;
* ``goodput``: every second of wall clock attributed to one phase;
* ``memscope``: device bytes attributed to owning subsystems;
* ``commscope``: per-axis probe latency and bandwidth, per-bucket chains;
* ``jitscope``: the kernel builds at first use, as compile events.

``trainer/train.py`` writes their digests into the rank's file
(``ConfigPath.RUNTIME_METRICS``.rank<id>), and the merge rules an agent
folds those files with are ``memscope.merge_digest``,
``jitscope.merge_digest`` and ``commscope.merge_digest``.

The master's side: ``sentinel`` (EWMA+MAD detectors over the time series
the master's store, ``master/timeseries.py``, keeps of those digests),
``incidents`` and ``timeline`` (the incident engine and its merged
timeline).
"""
