"""The port's PGLog, IndexedLog and PGMissing held to the reference's.

tests/test_pg_log.py's eighteen cases (ports of TestPGLog.cc's merge_log
and rewind_divergent_log corners and of the local machinery), each run
on both packages with the same entries: the final log (entries, head,
tail, object index), the missing set (need, have, is_delete per object),
the handler's remove/rollback/trim calls and any error are compared at
tolerance 0.  The reference's expectations ride along for the cases that
state them, so a shared mistake would still fail.
"""
from types import SimpleNamespace

import pytest

from ceph_tpu.osd import pg_log as ref_pg_log
from ceph_tpu.osd import pg_types as ref_pg_types
from ceph_tpu_torch.osd import pg_log as port_pg_log
from ceph_tpu_torch.osd import pg_types as port_pg_types

REF = SimpleNamespace(name="ref", log=ref_pg_log, t=ref_pg_types)
PORT = SimpleNamespace(name="port", log=port_pg_log, t=port_pg_types)


class Ops:
    """Builders over one package's types."""

    def __init__(self, ns):
        self.ns = ns
        self.Z = ns.t.ZERO_VERSION

    def v(self, e, v):
        return self.ns.t.EVersion(e, v)

    def mod(self, obj, version, prior, rb=False):
        return self.ns.t.PGLogEntry(self.ns.t.MODIFY, obj, version, prior,
                                    rollbackable=rb)

    def dt(self, obj, version, prior):
        return self.ns.t.PGLogEntry(self.ns.t.DELETE, obj, version, prior)

    def handler(self):
        base = self.ns.log.LogEntryHandler

        class Handler(base):
            def __init__(self):
                self.removed = set()
                self.rolled_back = []
                self.trimmed = []

            def remove(self, soid):
                self.removed.add(soid)

            def rollback(self, entry):
                self.rolled_back.append(entry)

            def trim(self, entry):
                self.trimmed.append(entry)

        return Handler()

    def run(self, base, div, auth, init_missing=(), may_include_deletes=True,
            div_bounds=None, auth_bounds=None):
        L = self.ns.log
        ours = L.IndexedLog(base + div)
        olog = L.IndexedLog(base + auth)
        if base:
            ours.tail = olog.tail = self.Z
        if div_bounds:
            ours.head, ours.tail = div_bounds
        if auth_bounds:
            olog.head, olog.tail = auth_bounds
        missing = self.ns.t.PGMissing(
            may_include_deletes=may_include_deletes)
        for soid, need, have in init_missing:
            missing.add(soid, need, have)
        pl = L.PGLog(ours, missing)
        h = self.handler()
        pl.merge_log(olog, h)
        return pl, h


def observe(pl=None, h=None, log=None, missing=None) -> dict:
    """Plain values of a log, a missing set and a handler."""
    out = {}
    log = pl.log if pl is not None else log
    missing = pl.missing if pl is not None else missing
    if log is not None:
        out["log"] = ([str(e) for e in log.entries], str(log.head),
                      str(log.tail), str(log.can_rollback_to),
                      sorted((k, str(e)) for k, e in log.objects.items()))
    if missing is not None:
        out["missing"] = sorted(
            (k, str(i.need), str(i.have), i.is_delete)
            for k, i in missing.items.items())
    if h is not None:
        out["handler"] = (sorted(h.removed),
                          [str(e) for e in h.rolled_back],
                          [str(e) for e in h.trimmed])
    return out


# --------------------------------------------------------------- cases

def merge_log_1_unrollbackable_divergent_removed(o):
    v = o.v
    pl, h = o.run([o.mod("obj1", v(10, 100), v(8, 80))],
                  [o.mod("obj1", v(10, 101), v(10, 100))], [])
    assert h.removed == {"obj1"}
    return observe(pl, h)


def merge_log_2_rollbackable_divergent_rolled_back(o):
    v = o.v
    pl, h = o.run([o.mod("obj1", v(10, 100), v(8, 80), rb=True)],
                  [o.mod("obj1", v(10, 101), v(10, 100), rb=True),
                   o.mod("obj1", v(10, 102), v(10, 101), rb=True)], [])
    assert [e.version for e in h.rolled_back] == [v(10, 102), v(10, 101)]
    return observe(pl, h)


def merge_log_3_mixed_rollbackability_removed(o):
    v = o.v
    pl, h = o.run([o.mod("obj1", v(10, 100), v(8, 80), rb=True)],
                  [o.mod("obj1", v(10, 101), v(10, 100)),
                   o.mod("obj1", v(10, 102), v(10, 101), rb=True)], [])
    assert h.removed == {"obj1"}
    return observe(pl, h)


def merge_log_4_already_missing_adjusted(o):
    v = o.v
    pl, h = o.run([o.mod("obj1", v(10, 100), v(8, 80), rb=True)],
                  [o.mod("obj1", v(10, 101), v(10, 100), rb=True),
                   o.mod("obj1", v(10, 102), v(10, 101), rb=True)], [],
                  init_missing=[("obj1", v(10, 102), o.Z)])
    assert pl.missing.items["obj1"].need == v(10, 100)
    return observe(pl, h)


def merge_log_5_auth_ahead_with_divergence(o):
    v = o.v
    pl, h = o.run([o.mod("obj1", v(10, 100), v(8, 80), rb=True)],
                  [o.mod("obj1", v(10, 101), v(10, 100)),
                   o.mod("obj1", v(10, 102), v(10, 101), rb=True)],
                  [o.mod("obj1", v(11, 101), v(10, 100))])
    assert pl.missing.items["obj1"].need == v(11, 101)
    return observe(pl, h)


def merge_log_6_simple_extend(o):
    v = o.v
    pl, h = o.run([o.mod("obj1", v(10, 100), v(8, 80), rb=True)], [],
                  [o.mod("obj1", v(11, 101), v(10, 100))])
    assert pl.missing.items["obj1"].have == v(10, 100)
    return observe(pl, h)


def merge_log_7_extend_already_missing_keeps_have(o):
    v = o.v
    pl, h = o.run([o.mod("obj1", v(10, 100), v(8, 80), rb=True)], [],
                  [o.mod("obj1", v(11, 101), v(10, 100))],
                  init_missing=[("obj1", v(10, 100), v(8, 80))])
    assert pl.missing.items["obj1"].have == v(8, 80)
    return observe(pl, h)


def merge_log_8_delete_tracked_in_missing(o):
    v = o.v
    pl, h = o.run([o.mod("obj1", v(10, 100), v(8, 80), rb=True)], [],
                  [o.dt("obj1", v(11, 101), v(10, 100))],
                  init_missing=[("obj1", v(10, 100), v(8, 80))])
    assert pl.missing.items["obj1"].is_delete
    return observe(pl, h)


def merge_log_9_deletes_during_peering_removed(o):
    v = o.v
    pl, h = o.run([o.mod("obj1", v(10, 100), v(8, 80), rb=True)], [],
                  [o.dt("obj1", v(11, 101), v(10, 100))],
                  init_missing=[("obj1", v(10, 100), v(8, 80))],
                  may_include_deletes=False)
    assert not pl.missing.items and h.removed == {"obj1"}
    return observe(pl, h)


def merge_log_prior_version_have(o):
    v = o.v
    pl, h = o.run([o.mod("obj1", v(10, 100), v(8, 80), rb=True)],
                  [o.mod("obj1", v(10, 101), v(10, 100))], [],
                  init_missing=[("obj1", v(10, 101), v(10, 100))])
    assert not pl.missing.items
    return observe(pl, h)


def merge_log_split_missing_entries_at_head(o):
    v = o.v
    pl, h = o.run([], [o.mod("obj1", v(8, 70), v(8, 65))],
                  [o.mod("obj1", v(10, 100), v(8, 70), rb=True),
                   o.mod("obj1", v(15, 150), v(10, 100), rb=True)],
                  div_bounds=(v(9, 79), v(8, 69)),
                  auth_bounds=(v(15, 160), v(9, 77)))
    assert pl.log.head == v(15, 160)
    return observe(pl, h)


def merge_log_no_overlap_raises(o):
    v, L = o.v, o.ns.log
    ours = L.IndexedLog([o.mod("a", v(1, 1), o.Z)])
    olog = L.IndexedLog([o.mod("b", v(5, 50), v(5, 49))], tail=v(5, 40))
    with pytest.raises(ValueError) as ei:
        L.PGLog(ours, o.ns.t.PGMissing()).merge_log(olog)
    return {"error": str(ei.value)}


def rewind_divergent_delete_entry(o):
    v, L = o.v, o.ns.log
    log = L.IndexedLog([o.mod("x5", v(1, 1), o.Z),
                        o.mod("x9", v(1, 4), o.Z),
                        o.dt("x9", v(1, 5), v(1, 4))], tail=v(1, 1))
    pl = L.PGLog(log, o.ns.t.PGMissing())
    h = o.handler()
    pl.rewind_divergent_log(v(1, 4), h)
    assert pl.missing.items["x9"].need == v(1, 4) and h.removed == set()
    return observe(pl, h)


def rewind_divergent_object_before_tail(o):
    v, L = o.v, o.ns.log
    log = L.IndexedLog([o.dt("x9", v(1, 5), v(0, 2))], tail=v(1, 1))
    pl = L.PGLog(log, o.ns.t.PGMissing())
    h = o.handler()
    pl.rewind_divergent_log(v(1, 3), h)
    assert pl.missing.items["x9"].need == v(0, 2)
    return observe(pl, h)


def rewind_divergent_creation_removed(o):
    v, L = o.v, o.ns.log
    log = L.IndexedLog([o.mod("keep", v(1, 1), o.Z),
                        o.mod("new", v(1, 5), o.Z)], tail=o.Z)
    pl = L.PGLog(log, o.ns.t.PGMissing())
    h = o.handler()
    pl.rewind_divergent_log(v(1, 1), h)
    assert h.removed == {"new"}
    return observe(pl, h)


def indexed_log_add_and_trim(o):
    v = o.v
    log = o.ns.log.IndexedLog()
    log.add(o.mod("a", v(1, 1), o.Z))
    log.add(o.mod("a", v(1, 2), v(1, 1)))
    log.add(o.mod("b", v(1, 3), o.Z))
    with pytest.raises(AssertionError):
        log.add(o.mod("c", v(1, 2), o.Z))
    dropped = log.trim_to(v(1, 2))
    return observe(log=log) | {"dropped": [str(e) for e in dropped]}


def missing_add_next_event_sequence(o):
    v = o.v
    m = o.ns.t.PGMissing()
    seen = []
    m.add_next_event(o.mod("o", v(1, 1), o.Z))
    seen.append(observe(missing=m))
    m.add_next_event(o.mod("o", v(1, 5), v(1, 1)))
    seen.append(observe(missing=m))
    m.got("o", v(1, 5))
    return seen + [observe(missing=m)]


def missing_got_partial(o):
    v = o.v
    m = o.ns.t.PGMissing()
    m.add("o", v(2, 2), v(1, 1))
    m.got("o", v(2, 1))
    seen = [observe(missing=m)]
    m.got("o", v(2, 2))
    return seen + [observe(missing=m)]


CASES = {f.__name__: f for f in (
    merge_log_1_unrollbackable_divergent_removed,
    merge_log_2_rollbackable_divergent_rolled_back,
    merge_log_3_mixed_rollbackability_removed,
    merge_log_4_already_missing_adjusted,
    merge_log_5_auth_ahead_with_divergence, merge_log_6_simple_extend,
    merge_log_7_extend_already_missing_keeps_have,
    merge_log_8_delete_tracked_in_missing,
    merge_log_9_deletes_during_peering_removed,
    merge_log_prior_version_have, merge_log_split_missing_entries_at_head,
    merge_log_no_overlap_raises, rewind_divergent_delete_entry,
    rewind_divergent_object_before_tail, rewind_divergent_creation_removed,
    indexed_log_add_and_trim, missing_add_next_event_sequence,
    missing_got_partial)}


@pytest.mark.parametrize("name", list(CASES))
def test_pg_log_case_equals_reference(name):
    ref = CASES[name](Ops(REF))
    port = CASES[name](Ops(PORT))
    assert port == ref
