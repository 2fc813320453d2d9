"""Worker-side dynamic data-shard consumer.

Copy of ``dlrover_tpu/agent/sharding.py``, the counterpart of DLRover's
``dlrover/python/elastic_agent/sharding/client.py`` (``ShardingClient:29``,
``IndexShardingClient:232``): training processes pull shard tasks from the
master, prefetch them into a local queue, report completions (keyed to
batch consumption), and can checkpoint/restore the master-side dispatch
position.  The shard checkpoint is the master's JSON string, so a position
taken from either package's master restores into the other's.
"""

import threading
import time
from typing import Dict, List, Optional

from dlrover_tpu_torch import chaos
from dlrover_tpu_torch.agent.master_client import (
    MasterClient,
    pace_reissue,
    ride_out_overload,
)
from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.common import envs
from dlrover_tpu_torch.common import retry as retry_mod
from dlrover_tpu_torch.observability import datascope, goodput, trace


def _finish_fetch(sp, dataset: str, wait_s: float, service_s: float):
    """Close out one ``data.fetch``: span attrs, the datascope scope,
    and — only when the blocked wall crossed the charge floor — the
    ledger's ``input_starved`` phase.  The charge is explicit and
    thresholded (never by span name, see ``goodput.SPAN_PHASE``): a
    prefetch micro-wait overlapped by compute must cost nothing, and
    slots where a step WAS running stay ``compute``'s anyway (the
    claim outranks ``input_starved``)."""
    starved = wait_s >= envs.get_float("DLROVER_TPU_DATA_STARVED_MIN_S")
    sp.set_attr("wait_s", round(wait_s, 6))
    sp.set_attr("service_s", round(service_s, 6))
    sp.set_attr("starved", starved)
    if starved:
        goodput.charge("input_starved", wait_s)
    datascope.record_fetch(dataset, wait_s, service_s, starved)


class ShardingClient:
    def __init__(
        self,
        dataset_name: str,
        batch_size: int,
        num_epochs: int,
        dataset_size: int,
        client: Optional[MasterClient] = None,
        shuffle: bool = False,
        num_minibatches_per_shard: int = 2,
        task_type: str = "training",
        storage_type: str = "",
    ):
        self._client = client or MasterClient.singleton_instance()
        self._dataset_name = dataset_name
        self._batch_size = batch_size
        self._lock = threading.Lock()
        # sticky: a fast-empty streak proved the batch path broken on
        # THIS master (mirror of the client's legacy-longpoll flag) —
        # without it every later fetch re-pays the ~8 paced re-issues
        self._batch_broken = False
        # tasks leased ahead by a batched envelope, consumed in order
        self._prefetched: List[comm.Task] = []
        self._current: Optional[comm.Task] = None
        self._reported_batches = 0
        self._batch_count_in_task = 0
        # when the current shard's fetch returned — the data.consume
        # span's retroactive start (wait-vs-process attribution)
        self._fetched_at = 0.0
        self._client.report_dataset_shard_params(
            batch_size=batch_size,
            num_epochs=num_epochs,
            dataset_size=dataset_size,
            shuffle=shuffle,
            num_minibatches_per_shard=num_minibatches_per_shard,
            dataset_name=dataset_name,
            task_type=task_type,
            storage_type=storage_type,
            splitter="batch",
        )

    @property
    def dataset_name(self) -> str:
        return self._dataset_name

    def fetch_shard(self) -> Optional[comm.Shard]:
        """Get the next shard range, or None when the dataset is finished.

        Leases ride the batched long-poll protocol:
        ``DLROVER_TPU_SHARD_LEASE_BATCH`` tasks per envelope (extras are
        prefetched client-side) and, when no shard is dispatchable yet,
        the master blocks the request up to ``DLROVER_TPU_SHARD_WAIT_S``
        instead of this client sleep-polling once a second.  An older
        master degrades to the legacy get_task loop.

        Datascope: the blocking portion rides a ``data.fetch`` span
        with a wait-vs-service split — time blocked on an empty
        pipeline (long-poll chunks, pacing/ride-out sleeps, leases the
        master could only answer after blocking) vs. fast RPC
        turnarounds.  The blocked wall past
        ``DLROVER_TPU_DATA_STARVED_MIN_S`` is charged to the ledger's
        ``input_starved`` phase; a prefetch hit costs neither."""
        with self._lock:
            if self._prefetched:
                task = self._prefetched.pop(0)
                self._current = task
                self._fetched_at = time.time()
                datascope.record_fetch(
                    self._dataset_name, 0.0, 0.0, False
                )
                return task.shard
        acct = {"wait_s": 0.0, "service_s": 0.0}
        with trace.span(
            "data.fetch", attrs={"dataset": self._dataset_name}
        ) as sp:
            if self._batch_broken:
                shard = self._fetch_shard_legacy(acct)
            else:
                shard = self._fetch_shard_batched(acct)
            _finish_fetch(
                sp, self._dataset_name, acct["wait_s"], acct["service_s"]
            )
        with self._lock:
            self._fetched_at = time.time()
        return shard

    def _fetch_shard_batched(
        self, acct: Dict[str, float]
    ) -> Optional[comm.Shard]:
        fast_empties = 0
        while True:
            t0 = time.time()
            # the chaos point sits inside the timed window: an injected
            # DELAY books as blocked wait, exactly like the real slow
            # pipeline it simulates
            fault = chaos.point("data.fetch", dataset=self._dataset_name)
            wait_s = envs.get_float("DLROVER_TPU_SHARD_WAIT_S")
            if fault is not None and fault.kind == chaos.DROP:
                # the lease envelope is lost in flight: re-issue paced,
                # without counting toward the fast-empty fallback (the
                # batch path itself is fine)
                pace_reissue(t0, 1.0)
                acct["wait_s"] += time.time() - t0
                continue
            try:
                batched = self._client.get_task_batch(
                    self._dataset_name,
                    count=envs.get_int("DLROVER_TPU_SHARD_LEASE_BATCH"),
                    wait_timeout=wait_s,
                )
            except retry_mod.OverloadedError as e:
                # an admission refusal is server-paced backpressure, not
                # a broken batch path: ride it out without counting
                # toward the fast-empty legacy fallback
                ride_out_overload(e)
                acct["wait_s"] += time.time() - t0
                continue
            elapsed = time.time() - t0
            fast = elapsed < min(1.0, wait_s / 2.0)
            # attribution boundary: a lease answered under the
            # starvation floor is dispatch work (service); past it the
            # worker was measurably blocked on the pipeline — whether
            # the master sat in its long-poll or served a stalled lease
            blocked = elapsed >= envs.get_float(
                "DLROVER_TPU_DATA_STARVED_MIN_S"
            )
            if batched is None:
                acct["service_s"] += elapsed
                return self._fetch_shard_legacy(acct)
            tasks, finished = batched
            if tasks:
                acct["wait_s" if blocked else "service_s"] += elapsed
                with self._lock:
                    self._current = tasks[0]
                    self._prefetched.extend(tasks[1:])
                return tasks[0].shard
            if finished:
                acct["service_s"] += elapsed
                return None
            acct["wait_s"] += elapsed
            # long-poll chunk expired with shards still in flight on
            # other workers: re-issue.  An ERROR reply comes back
            # without blocking server-side — pace it like the legacy
            # loop so a fast-failing master doesn't get stormed.  A
            # genuine expiry blocked ~wait_s server-side first, so a
            # streak of FAST empties means the batch path itself is
            # broken: bound the streak and drop to the legacy loop,
            # which terminates on a persistent error instead of
            # re-issuing forever.
            if fast:
                fast_empties += 1
                if fast_empties >= 8:
                    self._batch_broken = True
                    return self._fetch_shard_legacy(acct)
            else:
                fast_empties = 0
            t1 = time.time()
            pace_reissue(t0, 1.0)
            acct["wait_s"] += time.time() - t1

    def _fetch_shard_legacy(
        self, acct: Optional[Dict[str, float]] = None
    ) -> Optional[comm.Shard]:
        """Single-task sleep-poll loop for masters without the batch
        protocol."""
        acct = acct if acct is not None else {"wait_s": 0.0,
                                              "service_s": 0.0}
        while True:
            t0 = time.time()
            try:
                task = self._client.get_task(self._dataset_name)
            except retry_mod.OverloadedError as e:
                ride_out_overload(e)
                acct["wait_s"] += time.time() - t0
                continue
            elapsed = time.time() - t0
            blocked = elapsed >= envs.get_float(
                "DLROVER_TPU_DATA_STARVED_MIN_S"
            )
            acct["wait_s" if blocked else "service_s"] += elapsed
            if task.task_id >= 0:
                with self._lock:
                    self._current = task
                return task.shard
            if task.task_type == "wait":
                time.sleep(1.0)
                acct["wait_s"] += 1.0
                continue
            return None

    def report_batch_done(self, batch_count: int = 1):
        """Report task completion once a shard's batches are consumed."""
        with self._lock:
            task = self._current
            if task is None:
                return
            self._batch_count_in_task += batch_count
            size = task.shard.end - task.shard.start
            shard_batches = max(
                1, -(-size // self._batch_size)  # ceil: partial batch counts
            )
            done = self._batch_count_in_task >= shard_batches
            fetched_at = self._fetched_at
            if done:
                self._batch_count_in_task = 0
                self._current = None
        if done:
            self._emit_consume(task, fetched_at)
            self._client.report_task_result(self._dataset_name, task.task_id)

    def report_shard_done(self):
        with self._lock:
            task, self._current = self._current, None
            fetched_at = self._fetched_at
        if task is not None:
            self._emit_consume(task, fetched_at)
            self._client.report_task_result(self._dataset_name, task.task_id)

    def _emit_consume(self, task: comm.Task, fetched_at: float) -> None:
        """The ``data.consume`` span: the worker-side processing window
        from fetch return to completion report, backdated so the
        Perfetto lane shows fetch|consume back to back."""
        now = time.time()
        process_s = max(0.0, now - fetched_at) if fetched_at > 0 else 0.0
        with trace.span(
            "data.consume",
            attrs={
                "dataset": self._dataset_name,
                "task_id": task.task_id,
                "process_s": round(process_s, 6),
            },
        ) as sp:
            if sp.sampled and fetched_at > 0:
                sp.start_ts = fetched_at
        datascope.record_consume(self._dataset_name, process_s)

    def get_shard_checkpoint(self) -> str:
        return self._client.get_shard_checkpoint(self._dataset_name)

    def restore_shard_from_checkpoint(self, content: str) -> bool:
        return self._client.report_shard_checkpoint(content)

    def get_current_epoch(self) -> int:
        return self._client.get_dataset_epoch(self._dataset_name)


class SPMDShardingClient:
    """Dynamic sharding for SPMD jobs: one logical shard stream.

    In torch-DDP each worker consumes its own shard stream (reference
    ShardingClient), but a mesh program requires every process to
    execute the same step sequence — divergent per-process streams deadlock
    the collectives.  Here process 0 owns the master-facing ShardingClient
    and broadcasts each fetched shard (or end-of-data) through the master
    KV store; all other processes replay the identical sequence and slice
    their per-host portion of each global batch by process index.
    """

    _END = b"__END__"

    def __init__(
        self,
        dataset_name: str,
        batch_size: int,
        num_epochs: int,
        dataset_size: int,
        process_id: int,
        client: Optional[MasterClient] = None,
        shuffle: bool = False,
        num_minibatches_per_shard: int = 2,
        fetch_timeout: float = 600.0,
        session: Optional[str] = None,
    ):
        self._client = client or MasterClient.singleton_instance()
        self._dataset_name = dataset_name
        self._process_id = process_id
        self._seq = 0
        self._fetch_timeout = fetch_timeout
        # Scope broadcast keys to this worker incarnation: after a restart
        # every process resets _seq, and unscoped keys would replay stale
        # shards from the previous incarnation to the followers.
        if session is None:
            session = (
                str(envs.get_int("DLROVER_TPU_RDZV_ROUND"))
                + "-"
                + str(envs.get_int("DLROVER_TPU_RESTART_COUNT"))
            )
        self._session = session
        self._inner: Optional[ShardingClient] = None
        if process_id == 0:
            self._inner = ShardingClient(
                dataset_name=dataset_name,
                batch_size=batch_size,
                num_epochs=num_epochs,
                dataset_size=dataset_size,
                client=self._client,
                shuffle=shuffle,
                num_minibatches_per_shard=num_minibatches_per_shard,
            )

    def fetch_shard(self) -> Optional[comm.Shard]:
        key = (
            f"shard_bcast/{self._dataset_name}/{self._session}/{self._seq}"
        )
        self._seq += 1
        if self._inner is not None:
            shard = self._inner.fetch_shard()
            if shard is None:
                self._client.kv_store_set(key, self._END)
                return None
            payload = f"{shard.name}|{shard.start}|{shard.end}".encode()
            self._client.kv_store_set(key, payload)
            return shard
        # follower: the broadcast wait IS this process's fetch — it
        # covers rank0's lease plus the kv hop, so it carries the same
        # data.fetch attribution (all wait beyond a fast kv turnaround)
        with trace.span(
            "data.fetch",
            attrs={"dataset": self._dataset_name, "follower": True},
        ) as sp:
            t0 = time.time()
            raw = self._client.kv_store_wait(
                key, timeout=self._fetch_timeout
            )
            elapsed = time.time() - t0
            fast = elapsed < 0.05
            _finish_fetch(
                sp, self._dataset_name,
                0.0 if fast else elapsed, elapsed if fast else 0.0,
            )
        if not raw:
            raise TimeoutError(f"shard broadcast {key} never arrived")
        if raw == self._END:
            return None
        name, start, end = raw.decode().split("|")
        return comm.Shard(name=name, start=int(start), end=int(end))

    def report_batch_done(self, batch_count: int = 1):
        if self._inner is not None:
            self._inner.report_batch_done(batch_count)

    def get_shard_checkpoint(self) -> str:
        if self._inner is not None:
            return self._inner.get_shard_checkpoint()
        return ""

    def restore_shard_from_checkpoint(self, content: str) -> bool:
        if self._inner is not None:
            return self._inner.restore_shard_from_checkpoint(content)
        return False


class IndexShardingClient(ShardingClient):
    """Yields record indices one by one (reference ``IndexShardingClient``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._indices: List[int] = []

    def fetch_record_index(self) -> Optional[int]:
        if not self._indices:
            shard = self.fetch_shard()
            if shard is None:
                return None
            self._indices = (
                list(shard.record_indices)
                if shard.record_indices
                else list(range(shard.start, shard.end))
            )
        return self._indices.pop(0)
