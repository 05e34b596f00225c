"""cephck for the port: the static device-contract rules.

The port's copy of `ceph_tpu.analysis` in part: the rule engine (parse
every file once, a project call graph, inline waivers) and three rules
that police the host<->device boundary on the CUDA path, the torch
counterparts of the reference's `jax-timing`, `host-sync-hot-path` and
`implicit-transfer`.  Run it from the repository root::

    python -m ceph_tpu_torch.analysis ceph_tpu_torch chip_smoke.py

Exit 0 means no finding that is not waived.  A waiver is a comment on
the finding's line or the line above it,
``# cephck: ignore[<rule>] <reason>``, and it waives nothing without
its reason.  Left out: the suppression baseline file, the other rules
of the reference (locks, wire schema, the jit and tracer rules, the
concurrency family) and the json/github/sarif output formats.
"""
from .engine import Engine, FileContext, Finding, main  # noqa: F401
from .rules import ALL_RULES  # noqa: F401
