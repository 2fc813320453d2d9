"""Parallel-config tuner: master suggestions -> file the workers poll.

Copy of ``dlrover_tpu/agent/config_tuner.py``, its imports the port's.

The JAX package's counterpart of DLRover's ``dlrover/python/elastic_agent/config/
paral_config_tuner.py:101``: the agent periodically fetches the master's
ParallelConfig (dataloader batch size / grad-accum / mesh-axis hints) and
writes it to ``ConfigPath.PARAL_CONFIG``; workers (ElasticDataLoader,
Trainer) poll the file between steps — auto-tuning without an RPC in the
training loop.
"""

import json
import os
import threading
from typing import Optional

from dlrover_tpu_torch.common.constants import ConfigPath
from dlrover_tpu_torch.common import envs
from dlrover_tpu_torch.common.log import logger


class ParalConfigTuner:
    def __init__(self, client=None, interval_secs: float = 30.0,
                 config_path: str = ""):
        from dlrover_tpu_torch.agent.master_client import MasterClient

        self._client = client or MasterClient.singleton_instance()
        self._interval = interval_secs
        self._path = config_path or envs.get_str(
            ConfigPath.ENV_PARAL_CONFIG
        )
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        if self._client is None:
            return
        os.makedirs(os.path.dirname(self._path), exist_ok=True)
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="paral-config-tuner"
        )
        self._thread.start()

    def stop(self):
        self._stopped.set()

    def _loop(self):
        while not self._stopped.wait(self._interval):
            try:
                self.fetch_and_write()
            except Exception as e:  # noqa: BLE001 - tuning best-effort
                logger.debug("paral config fetch failed: %s", e)

    def fetch_and_write(self) -> bool:
        config = self._client.get_paral_config()
        payload = {
            "dataloader": {
                "batch_size": config.dataloader.batch_size,
                "num_workers": config.dataloader.num_workers,
                "version": config.dataloader.version,
            },
            "optimizer": {
                "learning_rate": config.optimizer.learning_rate,
                "micro_batch_size": config.optimizer.micro_batch_size,
                "grad_accum_steps": config.optimizer.grad_accum_steps,
                "version": config.optimizer.version,
            },
            "mesh_axes": dict(config.mesh_axes),
            "restart": bool(config.restart),
        }
        tmp = self._path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, self._path)
        return True
