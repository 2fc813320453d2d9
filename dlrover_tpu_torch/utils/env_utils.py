"""Host/network environment helpers.

Copy of ``dlrover_tpu/utils/env_utils.py``, its imports the port's.
"""

import os
import socket
from contextlib import closing
from typing import Optional


def find_free_port(host: str = "") -> int:
    with closing(socket.socket(socket.AF_INET, socket.SOCK_STREAM)) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, 0))
        return s.getsockname()[1]


def find_free_port_in_range(start: int, end: int) -> int:
    for port in range(start, end):
        with closing(socket.socket(socket.AF_INET, socket.SOCK_STREAM)) as s:
            try:
                s.bind(("", port))
                return port
            except OSError:
                continue
    raise RuntimeError(f"no free port in [{start}, {end})")


def get_host_ip() -> str:
    try:
        with closing(socket.socket(socket.AF_INET, socket.SOCK_DGRAM)) as s:
            s.connect(("8.8.8.8", 80))
            return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"


def get_host_name() -> str:
    return socket.gethostname()


def get_env_int(name: str, default: int) -> int:
    try:
        return int(os.getenv(name, default))
    except (TypeError, ValueError):
        return default


def get_env_float(name: str, default: float) -> float:
    try:
        return float(os.getenv(name, default))
    except (TypeError, ValueError):
        return default


def get_env_bool(name: str, default: bool = False) -> bool:
    val = os.getenv(name)
    if val is None:
        return default
    return val.lower() in ("1", "true", "yes", "on")


def port_reachable(host: str, port: int, timeout: float = 1.0) -> bool:
    try:
        with closing(socket.create_connection((host, port), timeout=timeout)):
            return True
    except OSError:
        return False


def resolve_master_addr() -> Optional[str]:
    from dlrover_tpu_torch.common import envs
    from dlrover_tpu_torch.common.constants import NodeEnv

    return envs.get_str(NodeEnv.MASTER_ADDR) or None
