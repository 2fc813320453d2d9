"""Seeded, deterministic fault injection (copy of ``dlrover_tpu/chaos``).

Usage from a test or drill::

    from dlrover_tpu_torch import chaos

    chaos.configure(chaos.ChaosPlan(
        name="kv-timeouts", seed=7,
        faults=[chaos.FaultSpec(point="kv_store.get", kind=chaos.DROP,
                                on_calls=[2, 3])],
    ))
    try:
        ...  # every kv_store.get call now consults the plan
        assert [r["point"] for r in chaos.trace()] == ["kv_store.get"] * 2
    finally:
        chaos.clear()

Production processes arm only through the ``DLROVER_TPU_CHAOS`` env
knob (default off); injection sites call :func:`point` unconditionally.
"""

from dlrover_tpu_torch.chaos.engine import (  # noqa: F401
    CALLBACK,
    DELAY,
    DROP,
    EXCEPTION,
    FAULT_KINDS,
    FLAP,
    TORN_WRITE,
    ChaosEngine,
    ChaosError,
    ChaosPlan,
    Fault,
    FaultSpec,
    clear,
    configure,
    engine,
    inject,
    is_active,
    point,
    trace,
)
from dlrover_tpu_torch.chaos.scenarios import (  # noqa: F401
    SCENARIOS,
    scenario_plan,
)
