"""Per-chip device metric taxonomy, and the node sample the agent takes.

Copy of ``dlrover_tpu/common/metric.py`` with the same names, because the
master reads them by name (``TpuMetricEnum``, ``TpuChipMetric``,
``NodeTpuMetric``): the schema between the agent's monitor (producer),
the master's metric context, the dashboard and the diagnosticians.

Sources, in honesty order:

- the card's allocator (``torch.cuda.memory_stats``: bytes in use and
  their peak, ``allocated_bytes.all.current`` / ``.peak``) and its total
  memory (``torch.cuda.mem_get_info``), for every card sampled;
- the deployment's runtime metrics endpoint (Prometheus text,
  ``DLROVER_TPU_DEVICE_METRICS_URL``): duty cycle, core utilization and
  interconnect counters when the deployment exposes them, parsed with a
  copy of the reference's ``diagnosis/collectors.parse_prometheus``.

An absent field is ``UNKNOWN`` (-1), never 0: a 0 is evidence, an unknown
value is not.  On the CPU every HBM field is ``UNKNOWN``.
"""

import functools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from dlrover_tpu_torch.common import envs
from dlrover_tpu_torch.device import DeviceLike, resolve_device

UNKNOWN = -1.0


class TpuMetricEnum:
    """Metric keys (reference GpuMetricEnum/NpuMetricEnum)."""

    HBM_USED_MB = "hbm_used_mb"
    HBM_TOTAL_MB = "hbm_total_mb"
    HBM_PEAK_MB = "hbm_peak_mb"
    DUTY_CYCLE = "duty_cycle_pct"  # % of time the core executed
    TENSORCORE_UTIL = "tensorcore_util_pct"  # MXU utilization
    ICI_TX_MBPS = "ici_tx_mbps"  # inter-chip interconnect out
    ICI_RX_MBPS = "ici_rx_mbps"  # inter-chip interconnect in
    ALL = [
        HBM_USED_MB, HBM_TOTAL_MB, HBM_PEAK_MB, DUTY_CYCLE,
        TENSORCORE_UTIL, ICI_TX_MBPS, ICI_RX_MBPS,
    ]


@dataclass
class TpuChipMetric:
    """One chip's sample (reference GpuMetric, metric.py:38)."""

    chip_id: int = 0
    hbm_used_mb: float = 0.0
    hbm_total_mb: float = 0.0
    hbm_peak_mb: float = UNKNOWN
    duty_cycle_pct: float = UNKNOWN
    tensorcore_util_pct: float = UNKNOWN
    ici_tx_mbps: float = UNKNOWN
    ici_rx_mbps: float = UNKNOWN

    def set_metric(self, key: str, value: float):
        if key in TpuMetricEnum.ALL:
            setattr(self, key, float(value))

    def get_metric(self, key: str) -> Optional[float]:
        if key in TpuMetricEnum.ALL:
            return getattr(self, key)
        return None

    @property
    def hbm_pressure(self) -> float:
        """Used/total in [0,1]; 0 when either side is unknown (a
        partial sample must not yield a negative pressure)."""
        if self.hbm_total_mb <= 0 or self.hbm_used_mb < 0:
            return 0.0
        return self.hbm_used_mb / self.hbm_total_mb

    def to_dict(self) -> Dict:
        return {
            "chip_id": self.chip_id,
            **{k: getattr(self, k) for k in TpuMetricEnum.ALL},
        }

    @classmethod
    def from_dict(cls, data: Dict) -> "TpuChipMetric":
        metric = cls(chip_id=int(data.get("chip_id", 0)))
        for key in TpuMetricEnum.ALL:
            if key in data:
                metric.set_metric(key, data[key])
        return metric


@dataclass
class NodeTpuMetric:
    """All chips of one host (reference NodeGpuMetric, metric.py:226)."""

    node_id: int = -1
    chips: List[TpuChipMetric] = field(default_factory=list)

    def avg(self, key: str) -> float:
        """Mean over chips with a KNOWN value; UNKNOWN when none has.
        A known 0.0 is evidence (fully idle) and must survive the
        filter — only the UNKNOWN sentinel is excluded."""
        vals = [
            v for c in self.chips
            if (v := c.get_metric(key)) is not None and v != UNKNOWN
        ]
        return sum(vals) / len(vals) if vals else UNKNOWN

    def max_hbm_pressure(self) -> float:
        return max((c.hbm_pressure for c in self.chips), default=0.0)

    def to_list(self) -> List[Dict]:
        return [c.to_dict() for c in self.chips]

    @classmethod
    def from_list(cls, node_id: int, data: List[Dict]) -> "NodeTpuMetric":
        return cls(
            node_id=node_id,
            chips=[TpuChipMetric.from_dict(d) for d in (data or [])],
        )


# -- collection (agent side) ------------------------------------------------


def _parse_labels(label_str: str) -> Dict[str, str]:
    """Label block -> dict, honoring quoted values (which may contain
    commas, braces, and ``\\"`` escapes — kernel/fusion names do)."""
    labels: Dict[str, str] = {}
    i, n = 0, len(label_str)
    while i < n:
        eq = label_str.find("=", i)
        if eq < 0:
            break
        key = label_str[i:eq].strip().lstrip(",").strip()
        j = eq + 1
        while j < n and label_str[j] in " \t":
            j += 1
        if j < n and label_str[j] == '"':
            j += 1
            value = []
            # exposition escapes: exactly \\ \" \n (anything else keeps
            # the char literally — '\t' is NOT an exposition escape)
            unescape = {"\\": "\\", '"': '"', "n": "\n"}
            while j < n and label_str[j] != '"':
                if label_str[j] == "\\" and j + 1 < n:
                    raw = label_str[j + 1]
                    value.append(unescape.get(raw, raw))
                    j += 2
                else:
                    value.append(label_str[j])
                    j += 1
            labels[key] = "".join(value)
            i = j + 1
        else:
            end = label_str.find(",", j)
            end = n if end < 0 else end
            labels[key] = label_str[j:end].strip()
            i = end + 1
    return labels


def parse_prometheus(text: str) -> List[Tuple[str, Dict[str, str], float]]:
    """Prometheus text format -> (name, labels, value) triples.

    Handles ``name value`` and ``name{k="v",...} value``; skips comments
    and malformed lines (a half-written page must not kill the scrape).
    """
    samples = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        # exposition format: name[{labels}] value [timestamp-ms] — the
        # value is the FIRST token after the label block (a trailing
        # timestamp must not be read as the value), and the label block
        # ends at the LAST '}' (label VALUES may contain '}')
        labels: Dict[str, str] = {}
        if "{" in line:
            name, _, rest = line.partition("{")
            label_str, _, tail = rest.rpartition("}")
            labels = _parse_labels(label_str)
            value_tokens = tail.split()
        else:
            tokens = line.split()
            if len(tokens) < 2:
                continue
            name = tokens[0]
            value_tokens = tokens[1:]
        if not value_tokens:
            continue
        try:
            value = float(value_tokens[0])
        except ValueError:
            continue
        samples.append((name.strip(), labels, value))
    return samples


def parse_prometheus(text: str) -> List[Tuple[str, Dict[str, str], float]]:
    """Prometheus text format -> (name, labels, value) triples.

    Handles ``name value`` and ``name{k="v",...} value``; skips comments
    and malformed lines (a half-written page must not kill the scrape).
    """
    samples = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        # exposition format: name[{labels}] value [timestamp-ms] — the
        # value is the FIRST token after the label block (a trailing
        # timestamp must not be read as the value), and the label block
        # ends at the LAST '}' (label VALUES may contain '}')
        labels: Dict[str, str] = {}
        if "{" in line:
            name, _, rest = line.partition("{")
            label_str, _, tail = rest.rpartition("}")
            labels = _parse_labels(label_str)
            value_tokens = tail.split()
        else:
            tokens = line.split()
            if len(tokens) < 2:
                continue
            name = tokens[0]
            value_tokens = tokens[1:]
        if not value_tokens:
            continue
        try:
            value = float(value_tokens[0])
        except ValueError:
            continue
        samples.append((name.strip(), labels, value))
    return samples


def _libtpu_samples() -> Dict[int, Dict[str, float]]:
    """chip_id -> partial metrics from the deployment's device-metrics
    Prometheus endpoint (DLROVER_TPU_DEVICE_METRICS_URL); {} when not
    configured/reachable."""
    url = envs.get_str("DLROVER_TPU_DEVICE_METRICS_URL")
    if not url:
        return {}
    try:
        import urllib.request

        with urllib.request.urlopen(url, timeout=3) as resp:
            samples = parse_prometheus(resp.read().decode())
    except Exception:  # noqa: BLE001 - endpoint is optional
        return {}
    # accept both tpu-info-style and megascale-style families
    name_map = {
        "tpu_duty_cycle_percent": TpuMetricEnum.DUTY_CYCLE,
        "duty_cycle": TpuMetricEnum.DUTY_CYCLE,
        "tpu_tensorcore_utilization": TpuMetricEnum.TENSORCORE_UTIL,
        "megascale_ici_transmitted_mbps": TpuMetricEnum.ICI_TX_MBPS,
        "megascale_ici_received_mbps": TpuMetricEnum.ICI_RX_MBPS,
    }
    out: Dict[int, Dict[str, float]] = {}
    for name, labels, value in samples:
        key = name_map.get(name)
        if key is None:
            continue
        try:
            chip = int(
                labels.get("chip_id", labels.get("device_id", 0))
            )
        except (TypeError, ValueError):
            chip = 0
        out.setdefault(chip, {})[key] = float(value)
    return out


def _cards(device: torch.device) -> List[int]:
    """The cards sampled: the one named, or every card of the node."""
    if device.index is not None:
        return [device.index]
    return list(range(torch.cuda.device_count()))


@functools.lru_cache(maxsize=None)
def card_total_bytes(index: int) -> float:
    """Card ``index``'s total memory (``torch.cuda.mem_get_info``), read
    once: it is fixed, and ``cudaMemGetInfo`` waits for the work queued on
    the card, which after a step costs the host the step's device tail."""
    return float(torch.cuda.mem_get_info(index)[1])


def card_memory(index: int) -> Dict[str, float]:
    """``{used_b, limit_b, peak_b}`` of card ``index``: the caching
    allocator's bytes in use and their peak, and the card's total."""
    stats = torch.cuda.memory_stats(index)
    return {
        "used_b": float(stats.get("allocated_bytes.all.current", 0)),
        "limit_b": card_total_bytes(index),
        "peak_b": float(stats.get("allocated_bytes.all.peak", 0)),
    }


def collect_node_tpu_metrics(node_id: int = -1,
                             device: DeviceLike = None) -> NodeTpuMetric:
    """The agent's per-sample collection: the memory of every card
    sampled (``device``: a card, ``"cuda"`` or None for every card of the
    node, ``"cpu"`` for one chip whose HBM fields are all ``UNKNOWN``),
    enriched with the endpoint's counters when exposed."""
    dev = resolve_device(device)
    chips: List[TpuChipMetric] = []
    extra = _libtpu_samples()
    if dev.type != "cuda":
        # the honesty contract: the CPU reports no device memory, and an
        # absent field is UNKNOWN (-1), never zero
        chip = TpuChipMetric(chip_id=0, hbm_used_mb=UNKNOWN,
                             hbm_total_mb=UNKNOWN, hbm_peak_mb=UNKNOWN)
        for key, value in extra.get(0, {}).items():
            chip.set_metric(key, value)
        return NodeTpuMetric(node_id=node_id, chips=[chip])
    for i in _cards(dev):
        mem = card_memory(i)
        chip = TpuChipMetric(
            chip_id=i,
            hbm_used_mb=mem["used_b"] / 2**20,
            hbm_total_mb=mem["limit_b"] / 2**20,
            hbm_peak_mb=mem["peak_b"] / 2**20,
        )
        for key, value in extra.get(i, {}).items():
            chip.set_metric(key, value)
        chips.append(chip)
    return NodeTpuMetric(node_id=node_id, chips=chips)
