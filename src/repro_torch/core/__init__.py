"""The engine's core: tables, catalog, queries, sketches, index, selection."""
from repro_torch.core.catalog import Catalog, default_catalog
from repro_torch.core.engine import PBDSEngine, RunInfo
from repro_torch.core.index import IndexEntry, SketchIndex, subsumes
from repro_torch.core.queries import (
    Aggregate,
    Having,
    JoinSpec,
    Predicate,
    Query,
    QueryResult,
    execute,
    execute_and_provenance,
    provenance_mask,
)
from repro_torch.core.ranges import RangeSet, equi_depth_ranges, equi_width_ranges, fragment_sizes
from repro_torch.core.safety import (
    prefilter_candidates,
    safe_attributes,
    stats_prefilter,
)
from repro_torch.core.sketch import (
    ProvenanceSketch,
    apply_sketch,
    capture_sketch,
    execute_with_sketch,
    is_safe_sketch,
    sketch_keep_mask,
)
from repro_torch.core.strategies import (
    ALL_STRATEGIES,
    COST_STRATEGIES,
    RANDOM_STRATEGIES,
    SelectionCache,
    SelectionConfig,
    SelectionResult,
    candidate_pool,
    select_attribute,
    selection_cache_key,
)
from repro_torch.core.table import ColumnTable, Database, encode_groups, from_numpy
from repro_torch.core.workload import WorkloadLog
