"""Dataset splitters for dynamic data sharding.

Copy of ``dlrover_tpu/master/dataset_splitter.py``, its imports the
port's.

The JAX package's counterpart of DLRover's
``dlrover/python/master/shard/dataset_splitter.py`` (DatasetSplitter ``:92``,
TableDatasetSplitter ``:146``, TextDatasetSplitter ``:259``,
StreamingDatasetSplitter ``:361``).  A dataset is split into contiguous
record ranges ("shards"); the task manager dispatches them to hosts and
re-queues those owned by dead hosts — elasticity of the *data* independent
of the mesh.
"""

import random
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import List


@dataclass
class Shard:
    name: str = ""
    start: int = 0
    end: int = 0
    record_indices: List[int] = field(default_factory=list)


class DatasetSplitter(ABC):
    def __init__(self, dataset_name: str, dataset_size: int, shard_size: int,
                 num_epochs: int = 1):
        self.dataset_name = dataset_name
        self.dataset_size = dataset_size
        self.shard_size = max(1, shard_size)
        self.num_epochs = max(1, num_epochs)
        self.epoch = 0

    @abstractmethod
    def create_shards(self) -> List[Shard]:
        """Create shards for the next epoch."""

    def epoch_finished(self) -> bool:
        return self.epoch >= self.num_epochs

    def get_epoch(self) -> int:
        return self.epoch

    # -- checkpoint --------------------------------------------------------

    def to_checkpoint(self) -> dict:
        return {
            "dataset_name": self.dataset_name,
            "dataset_size": self.dataset_size,
            "shard_size": self.shard_size,
            "num_epochs": self.num_epochs,
            "epoch": self.epoch,
            "splitter": type(self).__name__,
        }

    def restore_checkpoint(self, state: dict):
        self.epoch = state.get("epoch", 0)


class TableDatasetSplitter(DatasetSplitter):
    """Contiguous [start, end) ranges over an indexed table."""

    def __init__(self, dataset_name: str, dataset_size: int, shard_size: int,
                 num_epochs: int = 1):
        super().__init__(dataset_name, dataset_size, shard_size, num_epochs)

    def create_shards(self) -> List[Shard]:
        shards = []
        for i, start in enumerate(range(0, self.dataset_size, self.shard_size)):
            end = min(start + self.shard_size, self.dataset_size)
            shards.append(
                Shard(name=f"{self.dataset_name}-e{self.epoch}-s{i}",
                      start=start, end=end)
            )
        self.epoch += 1
        return shards


class TextDatasetSplitter(DatasetSplitter):
    """Ranges plus explicit (optionally shuffled) record indices per shard."""

    def __init__(self, dataset_name: str, dataset_size: int, shard_size: int,
                 num_epochs: int = 1, shuffle: bool = False, seed: int = 0):
        super().__init__(dataset_name, dataset_size, shard_size, num_epochs)
        self.shuffle = shuffle
        self._seed = seed

    def create_shards(self) -> List[Shard]:
        indices = list(range(self.dataset_size))
        if self.shuffle:
            rng = random.Random(self._seed + self.epoch)
            rng.shuffle(indices)
        shards = []
        for i, start in enumerate(range(0, self.dataset_size, self.shard_size)):
            end = min(start + self.shard_size, self.dataset_size)
            shards.append(
                Shard(
                    name=f"{self.dataset_name}-e{self.epoch}-s{i}",
                    start=start,
                    end=end,
                    record_indices=indices[start:end],
                )
            )
        self.epoch += 1
        return shards

    def to_checkpoint(self) -> dict:
        state = super().to_checkpoint()
        state["shuffle"] = self.shuffle
        state["seed"] = self._seed
        return state


class StreamingDatasetSplitter(DatasetSplitter):
    """Unbounded stream: emits fixed-size ranges from a moving offset."""

    def __init__(self, dataset_name: str, shard_size: int,
                 max_shard_count: int = 0, start_offset: int = 0):
        super().__init__(dataset_name, dataset_size=-1, shard_size=shard_size,
                         num_epochs=1)
        self.max_shard_count = max_shard_count
        self._offset = start_offset
        self._created = 0

    def epoch_finished(self) -> bool:
        return bool(
            self.max_shard_count and self._created >= self.max_shard_count
        )

    def create_shards(self) -> List[Shard]:
        batch = 100 if not self.max_shard_count else min(
            100, self.max_shard_count - self._created
        )
        shards = []
        for _ in range(max(0, batch)):
            shards.append(
                Shard(
                    name=f"{self.dataset_name}-o{self._offset}",
                    start=self._offset,
                    end=self._offset + self.shard_size,
                )
            )
            self._offset += self.shard_size
            self._created += 1
        return shards

    def to_checkpoint(self) -> dict:
        state = super().to_checkpoint()
        state["offset"] = self._offset
        state["created"] = self._created
        state["max_shard_count"] = self.max_shard_count
        return state

    def restore_checkpoint(self, state: dict):
        super().restore_checkpoint(state)
        self._offset = state.get("offset", 0)
        self._created = state.get("created", 0)


def new_dataset_splitter(
    splitter: str,
    shuffle: bool,
    dataset_size: int,
    batch_size: int,
    num_epochs: int,
    dataset_name: str,
    num_minibatches_per_shard: int = 2,
    storage_type: str = "",
) -> DatasetSplitter:
    """Factory mirroring reference ``dataset_splitter.new_dataset_splitter``."""
    shard_size = max(1, batch_size * max(1, num_minibatches_per_shard))
    if splitter == "streaming":
        return StreamingDatasetSplitter(dataset_name, shard_size)
    if storage_type == "text" or shuffle:
        return TextDatasetSplitter(
            dataset_name, dataset_size, shard_size, num_epochs, shuffle
        )
    return TableDatasetSplitter(
        dataset_name, dataset_size, shard_size, num_epochs
    )
