"""Dynamic data-shard task dispatch.

Copy of ``dlrover_tpu/master/task_manager.py``, its imports the port's.
The chaos point of a lease (``data.lease``) is a comment where it would
fire: the port has no chaos engine yet (ROADMAP item 7, the rest).

The JAX package's counterpart of DLRover's ``dlrover/python/master/shard/``
(``TaskManager`` ``task_manager.py:35``, ``recover_tasks`` ``:174``,
``BatchDatasetManager`` ``batch_dataset_manager.py``): datasets are split
into shard tasks, handed to hosts on request, re-queued when a host dies,
and the whole dispatch position is checkpointable so a restarted job resumes
the data stream without repeating or skipping shards.
"""

import json
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.master.dataset_splitter import (
    DatasetSplitter,
    Shard,
    new_dataset_splitter,
)


class TaskType:
    TRAINING = "training"
    EVALUATION = "evaluation"
    WAIT = "wait"
    NONE = "none"


@dataclass
class Task:
    task_id: int = -1
    task_type: str = TaskType.NONE
    shard: Shard = field(default_factory=Shard)
    retry_count: int = 0

    @classmethod
    def create_invalid_task(cls) -> "Task":
        return cls(task_id=-1, task_type=TaskType.NONE)

    @classmethod
    def create_wait_task(cls) -> "Task":
        return cls(task_id=-1, task_type=TaskType.WAIT)


@dataclass
class DoingTask:
    task: Task
    node_id: int
    start_time: float


class BatchDatasetManager:
    """Todo/doing bookkeeping for one dataset."""

    def __init__(self, task_type: str, splitter: DatasetSplitter):
        self._task_type = task_type
        self._splitter = splitter
        self.todo: List[Task] = []
        self.doing: Dict[int, DoingTask] = {}
        self._task_id_counter = 0
        self._completed_count = 0
        self._max_task_completed_time = 0.0

    @property
    def splitter(self) -> DatasetSplitter:
        return self._splitter

    @property
    def completed_count(self) -> int:
        return self._completed_count

    def get_task(self, node_id: int) -> Task:
        if not self.todo and not self._splitter.epoch_finished():
            self._create_tasks()
        if not self.todo:
            if self.doing:
                return Task.create_wait_task()
            return Task.create_invalid_task()
        task = self.todo.pop(0)
        self.doing[task.task_id] = DoingTask(task, node_id, time.time())
        return task

    def _create_tasks(self):
        for shard in self._splitter.create_shards():
            self.todo.append(
                Task(
                    task_id=self._task_id_counter,
                    task_type=self._task_type,
                    shard=shard,
                )
            )
            self._task_id_counter += 1

    def report_task_status(self, task_id: int, success: bool) -> bool:
        doing = self.doing.pop(task_id, None)
        if doing is None:
            return False
        if success:
            self._completed_count += 1
            elapsed = time.time() - doing.start_time
            self._max_task_completed_time = max(
                self._max_task_completed_time, elapsed
            )
        else:
            doing.task.retry_count += 1
            self.todo.insert(0, doing.task)
        return success

    def recover_tasks(self, node_id: int):
        """Re-queue shards a dead host was processing (reference
        ``task_manager.recover_tasks:174``)."""
        ids = [
            tid for tid, dt in self.doing.items() if dt.node_id == node_id
        ]
        for tid in ids:
            doing = self.doing.pop(tid)
            doing.task.retry_count += 1
            self.todo.insert(0, doing.task)
        if ids:
            logger.info(
                "recovered %d doing tasks of node %d for dataset %s",
                len(ids), node_id, self._splitter.dataset_name,
            )

    def completed(self) -> bool:
        return (
            self._splitter.epoch_finished()
            and not self.todo
            and not self.doing
        )

    def get_epoch(self) -> int:
        return self._splitter.get_epoch()

    # -- checkpoint --------------------------------------------------------

    def to_checkpoint(self) -> dict:
        todo_shards = [
            [t.shard.name, t.shard.start, t.shard.end] for t in self.todo
        ]
        doing_shards = [
            [dt.task.shard.name, dt.task.shard.start, dt.task.shard.end]
            for dt in self.doing.values()
        ]
        return {
            "task_type": self._task_type,
            "splitter": self._splitter.to_checkpoint(),
            "todo": todo_shards,
            "doing": doing_shards,
            "completed_count": self._completed_count,
            "task_id_counter": self._task_id_counter,
        }

    def restore_checkpoint(self, state: dict):
        self._splitter.restore_checkpoint(state.get("splitter", {}))
        self._completed_count = state.get("completed_count", 0)
        self._task_id_counter = state.get("task_id_counter", 0)
        self.todo.clear()
        self.doing.clear()
        # doing shards were in flight at checkpoint time: re-queue them first
        for name, start, end in state.get("doing", []) + state.get("todo", []):
            self.todo.append(
                Task(
                    task_id=self._task_id_counter,
                    task_type=self._task_type,
                    shard=Shard(name=name, start=start, end=end),
                )
            )
            self._task_id_counter += 1


class TaskManager:
    """All datasets of the job + speed-based worker eval (reference
    ``task_manager.py:35``)."""

    def __init__(self):
        # a Condition, not a bare Lock: long-poll leases block on it and
        # every dispatch-state mutation notifies, so a worker waiting
        # for a shard wakes the moment one becomes dispatchable instead
        # of sleep-polling the master
        self._lock = threading.Condition()
        self._datasets: Dict[str, BatchDatasetManager] = {}
        self._worker_starts: Dict[int, float] = {}
        # datascope observer (ShardTelemetry) — every hook fires
        # OUTSIDE the dispatch lock: a telemetry flush into the
        # time-series store must never hold up a lease
        self._telemetry = None

    def set_telemetry(self, telemetry) -> None:
        """Attach the datascope ``ShardTelemetry`` observer (servicer
        wiring; None detaches)."""
        self._telemetry = telemetry

    def _backlog_locked(self, dataset: "BatchDatasetManager") -> int:
        return len(dataset.todo) + len(dataset.doing)

    def new_dataset(
        self,
        batch_size: int,
        dataset_size: int,
        dataset_name: str,
        num_epochs: int = 1,
        shuffle: bool = False,
        num_minibatches_per_shard: int = 2,
        task_type: str = TaskType.TRAINING,
        storage_type: str = "",
        splitter: str = "batch",
    ):
        with self._lock:
            if dataset_name in self._datasets:
                return
            ds_splitter = new_dataset_splitter(
                splitter,
                shuffle,
                dataset_size,
                batch_size,
                num_epochs,
                dataset_name,
                num_minibatches_per_shard,
                storage_type,
            )
            self._datasets[dataset_name] = BatchDatasetManager(
                task_type, ds_splitter
            )
            logger.info(
                "new dataset %s: size=%d shard=%d epochs=%d",
                dataset_name, dataset_size,
                ds_splitter.shard_size, num_epochs,
            )
            self._lock.notify_all()

    def get_dataset_task(self, node_id: int, dataset_name: str) -> Optional[Task]:
        with self._lock:
            dataset = self._datasets.get(dataset_name)
            if dataset is None:
                return None
            return dataset.get_task(node_id)

    def lease_dataset_tasks(
        self, node_id: int, dataset_name: str, count: int = 1
    ) -> Tuple[List[Task], bool]:
        """Non-blocking batched lease: up to ``count`` dispatchable
        tasks plus the dataset's finished flag.  A missing dataset reads
        as finished (mirrors the single-task path, where a lost dataset
        yields an invalid task and the consumer stops)."""
        t0 = time.time()
        # chaos point "data.lease" (DROP: an empty batch): no chaos engine
        # in the port yet (ROADMAP item 7, the rest)
        with self._lock:
            tasks, finished = self._lease_locked(
                node_id, dataset_name, count
            )
            backlog, epoch = self._dataset_depth_locked(dataset_name)
        self._observe_lease(
            dataset_name, tasks, 0.0, time.time() - t0, backlog, epoch
        )
        return tasks, finished

    def wait_dataset_tasks(
        self,
        node_id: int,
        dataset_name: str,
        count: int = 1,
        timeout: float = 30.0,
    ) -> Tuple[List[Task], bool]:
        """Long-poll lease: block until at least one task is
        dispatchable, the dataset finishes, or ``timeout`` passes.
        An empty batch with ``finished=False`` means re-poll."""
        t0 = time.time()
        # chaos point "data.lease" (DROP: an empty batch; item 7, the rest)
        deadline = time.time() + max(0.0, timeout)
        queue_wait = 0.0
        with self._lock:
            while True:
                tasks, finished = self._lease_locked(
                    node_id, dataset_name, count
                )
                if tasks or finished:
                    break
                remaining = deadline - time.time()
                if remaining <= 0:
                    tasks = []
                    break
                wait0 = time.time()
                self._lock.wait(remaining)
                # queue-vs-service split: Condition waits are QUEUE
                # time (no dispatchable work existed), the rest of the
                # call is SERVICE time (the master working the lease)
                queue_wait += time.time() - wait0
            backlog, epoch = self._dataset_depth_locked(dataset_name)
        self._observe_lease(
            dataset_name, tasks, queue_wait,
            (time.time() - t0) - queue_wait, backlog, epoch,
        )
        return tasks, finished

    def _lease_locked(
        self, node_id: int, dataset_name: str, count: int
    ) -> Tuple[List[Task], bool]:
        dataset = self._datasets.get(dataset_name)
        if dataset is None:
            return [], True
        tasks: List[Task] = []
        for _ in range(max(1, count)):
            task = dataset.get_task(node_id)
            if task.task_id < 0:
                break
            tasks.append(task)
        return tasks, dataset.completed()

    def _dataset_depth_locked(self, dataset_name: str) -> Tuple[int, int]:
        dataset = self._datasets.get(dataset_name)
        if dataset is None:
            return 0, 0
        return self._backlog_locked(dataset), dataset.get_epoch()

    def _observe_lease(self, dataset_name: str, tasks: List[Task],
                       queue_wait_s: float, service_s: float,
                       backlog: int, epoch: int) -> None:
        telemetry = self._telemetry
        if telemetry is None:
            return
        telemetry.on_lease(
            dataset_name, len(tasks), queue_wait_s,
            max(0.0, service_s), backlog, epoch,
        )

    def report_dataset_task(
        self, dataset_name: str, task_id: int, success: bool
    ) -> bool:
        with self._lock:
            dataset = self._datasets.get(dataset_name)
            if dataset is None:
                return False
            doing = dataset.doing.get(task_id)
            leased_at = doing.start_time if doing is not None else None
            result = dataset.report_task_status(task_id, success)
            # a failed task re-queues; a completed one can finish the
            # dataset or open the next epoch — either way, waiters in
            # wait_dataset_tasks have something new to look at
            self._lock.notify_all()
            backlog = self._backlog_locked(dataset)
            epoch = dataset.get_epoch()
        telemetry = self._telemetry
        if telemetry is not None and result:
            latency = (
                time.time() - leased_at if leased_at is not None else -1.0
            )
            telemetry.on_complete(dataset_name, latency, backlog, epoch)
        return result

    def recover_tasks(self, node_id: int):
        with self._lock:
            for dataset in self._datasets.values():
                dataset.recover_tasks(node_id)
            self._lock.notify_all()
            depths = [
                (name, self._backlog_locked(ds), ds.get_epoch())
                for name, ds in self._datasets.items()
            ]
        telemetry = self._telemetry
        if telemetry is not None:
            for name, backlog, epoch in depths:
                telemetry.on_backlog(name, backlog, epoch)

    def get_dataset(self, name: str) -> Optional[BatchDatasetManager]:
        return self._datasets.get(name)

    def get_dataset_epoch(self, name: str) -> int:
        dataset = self._datasets.get(name)
        return dataset.get_epoch() if dataset else 0

    def finished(self) -> bool:
        with self._lock:
            if not self._datasets:
                return False
            return all(d.completed() for d in self._datasets.values())

    def get_dataset_checkpoint(self, dataset_name: str) -> str:
        with self._lock:
            dataset = self._datasets.get(dataset_name)
            if dataset is None:
                return ""
            return json.dumps(dataset.to_checkpoint())

    def restore_dataset_from_checkpoint(self, content: str) -> bool:
        try:
            state = json.loads(content)
            splitter_state = state.get("splitter", {})
            name = splitter_state.get("dataset_name", "")
            with self._lock:
                dataset = self._datasets.get(name)
                if dataset is None:
                    return False
                dataset.restore_checkpoint(state)
                self._lock.notify_all()
                return True
        except (ValueError, KeyError) as e:
            logger.warning("restore dataset checkpoint failed: %s", e)
            return False
