"""Elastic distributed sampler with a checkpointable position.

Copy of ``dlrover_tpu/trainer/elastic/sampler.py``, the counterpart of
DLRover's ``dlrover/trainer/torch/elastic/sampler.py``
(``ElasticDistributedSampler:155``): deterministic per-epoch shuffling,
rank-strided sharding, and a saveable/restorable offset so a restarted or
re-scaled job resumes the data stream mid-epoch without repeating or
skipping samples.  Framework-free (yields indices) so it feeds any loader;
the same seed, epoch, rank and world yield the reference's indices, and a
``state_dict`` of either package loads into the other's sampler.
"""

import random
from typing import Dict, Iterator, Optional


class ElasticDistributedSampler:
    def __init__(
        self,
        dataset_size: int,
        num_replicas: int = 1,
        rank: int = 0,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
    ):
        if rank >= num_replicas:
            raise ValueError(f"rank {rank} >= num_replicas {num_replicas}")
        self.dataset_size = dataset_size
        self.num_replicas = max(1, num_replicas)
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        # consumed GLOBAL samples this epoch (across all replicas)
        self.completed_global = 0

    # -- iteration ---------------------------------------------------------

    def _epoch_indices(self):
        indices = list(range(self.dataset_size))
        if self.shuffle:
            rng = random.Random(self.seed + self.epoch)
            rng.shuffle(indices)
        if self.drop_last:
            usable = (
                self.dataset_size // self.num_replicas
            ) * self.num_replicas
            indices = indices[:usable]
        return indices

    def __iter__(self) -> Iterator[int]:
        indices = self._epoch_indices()
        start = self.completed_global + self.rank
        for global_pos in range(start, len(indices), self.num_replicas):
            # a sample counts as consumed when handed out (the generator
            # body after `yield` only resumes on the NEXT call, which
            # would under-count the checkpointed position by one stride)
            self.completed_global = min(
                len(indices),
                global_pos - self.rank + self.num_replicas,
            )
            yield indices[global_pos]

    def __len__(self) -> int:
        remaining = max(0, len(self._epoch_indices()) - self.completed_global)
        return (remaining + self.num_replicas - 1 - self.rank) // max(
            1, self.num_replicas
        )

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        self.completed_global = 0

    # -- elasticity / checkpoint -------------------------------------------

    def record_batch(self, batch_size_global: int):
        """Alternative to iterating bookkeeping: advance by a global batch."""
        self.completed_global = min(
            self.dataset_size, self.completed_global + batch_size_global
        )

    def state_dict(self) -> Dict:
        return {
            "epoch": self.epoch,
            "completed_global": self.completed_global,
            "seed": self.seed,
            "shuffle": self.shuffle,
            "dataset_size": self.dataset_size,
        }

    def load_state_dict(self, state: Dict, num_replicas: Optional[int] = None,
                        rank: Optional[int] = None):
        """Restore position; the new world size may differ (elastic): the
        global offset is world-independent, so a rescaled job continues
        exactly where the old one stopped."""
        self.epoch = state.get("epoch", 0)
        self.completed_global = state.get("completed_global", 0)
        self.seed = state.get("seed", self.seed)
        self.shuffle = state.get("shuffle", self.shuffle)
        if num_replicas is not None:
            self.num_replicas = num_replicas
        if rank is not None:
            self.rank = rank


class ElasticDataLoader:
    """Minimal batch iterator over a sampler + fetch function, with a
    master-tunable batch size (counterpart of reference
    ``elastic/dataloader.py``: config version polled from the paral-config
    file written by the agent)."""

    def __init__(self, fetch_fn, sampler: ElasticDistributedSampler,
                 batch_size: int, config_path: str = ""):
        self._fetch = fetch_fn
        self.sampler = sampler
        self.batch_size = batch_size
        self._config_path = config_path
        self._config_version = -1

    def maybe_update_batch_size(self):
        """Pick up the master's dataloader suggestion if it changed."""
        if not self._config_path:
            return
        import json
        import os

        if not os.path.exists(self._config_path):
            return
        try:
            with open(self._config_path) as f:
                config = json.load(f)
        except (OSError, ValueError):
            return
        dl = config.get("dataloader", {})
        version = dl.get("version", -1)
        if version > self._config_version and dl.get("batch_size"):
            self._config_version = version
            self.batch_size = int(dl["batch_size"])

    def __iter__(self):
        self.maybe_update_batch_size()
        batch = []
        for index in self.sampler:
            batch.append(index)
            if len(batch) == self.batch_size:
                yield self._fetch(batch)
                batch = []
        if batch:
            yield self._fetch(batch)
