"""Multi-device layouts. So far only the table-sharding planner
(``sharded_table.plan_table_sharding``, numpy), which ``plan.py`` reads for
``--plan_devices``; the sharded and data-parallel trainers are not ported
yet (ROADMAP.md, queue 1)."""

from .sharded_table import TableShardingPlan, plan_table_sharding

__all__ = ["TableShardingPlan", "plan_table_sharding"]
