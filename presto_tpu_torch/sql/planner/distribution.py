"""Join distribution selection (DetermineJoinDistributionType + AddExchanges).

Copy of ``presto_tpu/sql/planner/distribution.py`` with the imports
rewritten.  The reference's distribution planning
(``sql/planner/iterative/rule/DetermineJoinDistributionType.java`` +
``sql/planner/optimizations/AddExchanges.java:120-245``) stamps each hash
join REPLICATED (the build side broadcast to every rank) or PARTITIONED
(both sides routed by a hash of the join keys, so that build and probe of
a key meet on one rank).  The exchanges themselves are collectives run by
``parallel/distributed.py``; this pass only decides the property.

The decision is a cost-hooked rule (``rules.DetermineJoinDistributionType``)
run through the iterative engine; this module keeps the pass-style entry
point the runner calls.
"""

from __future__ import annotations

from ...exec import plan as P
from .rules import DetermineJoinDistributionType, IterativeOptimizer


def add_exchanges(plan: P.PhysOp, broadcast_row_limit: float) -> P.PhysOp:
    """PARTITIONED when the planner's build-side row estimate exceeds
    ``broadcast_row_limit`` (reference default decision: size-based
    AUTOMATIC, ``join_max_broadcast_table_size``).  Joins with unknown
    estimates or constant keys (cross joins: hashing a constant would
    route every row to one rank) stay REPLICATED."""
    rule = DetermineJoinDistributionType(broadcast_row_limit)
    return IterativeOptimizer([rule]).optimize(plan)
