"""repairc: the repair-schedule compiler.

Lowers a plugin's repair plan for one concrete erasure *signature*
(code, failed-shard set, survivor set, per-helper sub-chunk extents)
into a single fused repair *program*: gather the survivor planes into
one dense array, run one GF(2^8) matmul (K1 on the card) against a
probe-derived repair matrix, scatter the rebuilt shard streams back
out.  Programs are cached per signature in a cost-weighted LRU
(`RepairProgramCache`, generalizing the decode-*matrix* cache of
ec/matrix_code.py to repair-*programs*), so steady-state recovery never
re-derives or re-compiles the schedule.

Plugins contribute plans through the `repair_schedule(erasures,
available)` interface hook (ec/interface.py); `None` means "no partial
plan for this signature" and callers fall back to wholesale full-chunk
recovery.

The port's copy of `ceph_tpu.ec.repairc`.
"""
from .plan import RepairPlan
from .compiler import (RepairPlanError, RepairProgram, compile_program,
                       interpret_plan)
from .cache import RepairProgramCache, program_for, cache_of

__all__ = ["RepairPlan", "RepairPlanError", "RepairProgram",
           "RepairProgramCache", "compile_program", "interpret_plan",
           "program_for", "cache_of"]
