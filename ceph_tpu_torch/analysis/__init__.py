"""cephck for the port: the static rules.

The port's copy of `ceph_tpu.analysis`: the rule engine (parse every
file once, a project call graph, inline waivers, the suppression
baseline, text/json/github/sarif reports), the three rules that police
the host<->device boundary on the CUDA path (the torch counterparts of
the reference's `jax-timing`, `host-sync-hot-path` and
`implicit-transfer`) and the reference's twelve other rules.  Run it
from the repository root::

    python -m ceph_tpu_torch.analysis ceph_tpu_torch chip_smoke.py

Exit 0 means no finding that is not waived or suppressed, 1 findings
(or a stale baseline entry), 2 a bad path or baseline.  A waiver is a
comment on the finding's line or the line above it,
``# cephck: ignore[<rule>] <reason>``, and it waives nothing without
its reason.  The baseline is ``.cephck-torch-baseline.json`` at the
repository root; every entry needs a one-line reason.
"""
from .engine import (Engine, FileContext, Finding,  # noqa: F401
                     load_baseline, main)
from .rules import ALL_RULES  # noqa: F401
