"""The port's peer-restore smoke (``observability/recovery_smoke.py``)
held to the reference's (``dlrover_tpu/observability/recovery_smoke.py``)
on the CPU: one of 4 local hosts dies and is refilled from the survivors'
shm through a real servicer's broker, with zero storage reads, a segment
byte-identical to a donor's, the survivors' compile-cache entries
prewarmed byte-identical, the report in the master's time-series store and
on the dashboard's recovery view, and the MTTR sentinel quiet.

Both smokes write the same seeded state, so the port moves the
reference's bytes.  With ``DLROVER_TPU_COMPILE_CACHE`` naming a directory
of built libraries, the port's survivors serve that directory, the agent's
compile cache (the kernel build directory on the card).
"""

import pytest

import dlrover_tpu.observability.recovery_smoke as j_smoke
import dlrover_tpu_torch.observability.recovery_smoke as p_smoke


@pytest.fixture(scope="module")
def smokes(tmp_path_factory):
    empty = tmp_path_factory.mktemp("no_kernels")
    with pytest.MonkeyPatch.context() as mp:
        # nothing built: the port's survivors serve stand-in entries
        mp.setenv("DLROVER_TPU_COMPILE_CACHE", str(empty))
        port = p_smoke.run_smoke("cpu")
    return port, j_smoke.run_smoke()


def test_the_reference_smoke_passes(smokes):
    assert smokes[1]["ok"], smokes[1]["checks"]


@pytest.mark.parametrize("check", [
    "survivors_announced", "broker_assigned_replica_donors",
    "zero_storage_reads", "restored_bit_exact", "cache_prewarmed",
    "mttr_under_drill_budget", "recovery_in_timeseries",
    "dashboard_replica_health", "mttr_sentinel_quiet"])
def test_port_passes_the_reference_check(smokes, check):
    port, ref = smokes
    assert ref["checks"][check]
    assert port["checks"][check], port


def test_same_checks_and_bytes_as_the_reference(smokes):
    port, ref = smokes
    assert set(port["checks"]) == set(ref["checks"])
    assert port["bytes_peer"] == ref["bytes_peer"] > 0
    assert port["ok"]


def test_survivors_serve_the_kernel_build_directory(tmp_path, monkeypatch):
    """A build directory holding libraries is what the survivors serve,
    and every entry lands byte-identical in the replacement's cache."""
    kernels = tmp_path / "kernels"
    kernels.mkdir()
    for name in ("libflash_attention_ab12.so", "libring_reduce_scatter_cd34.so",
                 "librdma_ring_ef56.so"):
        (kernels / name).write_bytes(name.encode() * 64)
    monkeypatch.setenv("DLROVER_TPU_COMPILE_CACHE", str(kernels))
    result = p_smoke.run_smoke("cpu")
    assert result["ok"], result["checks"]
    assert result["cache_entries"] == sorted(p.name for p in kernels.iterdir())
