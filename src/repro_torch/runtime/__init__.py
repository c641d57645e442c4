"""Runtime support: launch telemetry, stable hashing, retries and straggler
tracking, elastic re-planning and fault injection."""
from repro_torch.runtime.chaos import (
    COORD,
    COORD_FAULT_KINDS,
    ChaosEvent,
    ChaosHarness,
    differential,
    random_ops,
    random_schedule,
    run_ops,
)
from repro_torch.runtime.elastic import (
    ElasticPlan,
    feasible_mesh_shape,
    plan_remesh,
    plan_replacement,
)
from repro_torch.runtime.guards import LAUNCH_COUNTS, SHAPE_CLASSES, hot_path
from repro_torch.runtime.resilience import RetryPolicy, StragglerMonitor, with_retries
from repro_torch.runtime.stable_hash import canonical_repr, stable_hash32
