"""racecheck: Eraser-style lockset data-race sanitizer — lockdep for
the data the locks are supposed to guard.

lockdep (common/lockdep.py) proves the ORDER of lock acquisitions is
deadlock-free; it says nothing about whether the right lock was held
at all.  This module closes that gap with the classic Eraser lockset
algorithm (Savage et al., SOSP'97 — the same discipline behind
ThreadSanitizer builds of the reference): every instrumented
attribute access intersects a per-(object, attribute) CANDIDATE
LOCKSET with the set of DebugLocks the accessing thread currently
holds (lockdep already tracks holds per thread — `held_lock_names()`
is that feed).  When the candidate set goes empty on a write-shared
attribute, no single lock protected every access: that interleaving
can corrupt state, and ``RaceError`` fires with BOTH access stacks.

State machine per (object, attribute) — the standard refinement so
init-before-publish and single-threaded phases don't false-positive:

* **EXCLUSIVE** — only the creating thread has touched the attribute
  (the constructor / setup phase).  No lockset is tracked.
* **SHARED-READ** — a second thread read it; the candidate lockset
  starts as that thread's held set and is refined by every later
  access.  An empty set here is benign (read-only after publish).
* **SHARED-MODIFIED** — some thread wrote it after sharing.  From
  here every access refines the candidate set, and an empty
  intersection raises ``RaceError``.

Container-valued attributes (a dict of PGs, a connection map, an
LRU) mutate through READS of the attribute (``self._out[p] = s``
never rebinds ``_out``), so the binding-level machine above would
never see the write.  Declaring such attributes in ``mutating=``
makes reads FROM THE OBJECT'S OWN METHODS count as writes — that is
where content mutation lives — while reads from outside (a test
harness peeking a PG table) remain reads.  This is the runtime twin
of the static guarded-by rule.

Arming mirrors lockdep and the device guard: the `racecheck` option
(env ``CEPH_TPU_RACECHECK=1``, which requires ``CEPH_TPU_LOCKDEP=1``)
is read when this module is imported and arms it then, so the
environment that arms the reference package's sanitizer arms this one
too; set without lockdep, it warns and stays off.  When the option is off, ``shared_state``/``RaceTracked`` only
RECORD the class — no method is replaced, no access pays anything.
``enable()`` retro-instruments every recorded class, so arming order
vs. import order does not matter.

The port's own copy of `ceph_tpu.common.racecheck`.

Hand-off patterns (an op built by one thread, queued, completed by
another) are not races: call ``transfer_ownership(obj)`` at the
hand-off point and the next accessor becomes the new exclusive
owner.
"""
from __future__ import annotations

import sys
import threading
import warnings

from .lockdep import held_lock_names, make_lock

__all__ = ["shared_state", "RaceTracked", "transfer_ownership",
           "enable", "disable", "enabled", "enable_if_configured",
           "RaceError", "races", "reset", "stats"]

#: instance-dict slot holding this object's per-attribute records —
#: always excluded from tracking
_RECS = "__race_recs__"

#: access-state constants (module-level ints: cheaper than an Enum on
#: a per-attribute-access path)
EXCLUSIVE, SHARED_READ, SHARED_MOD = 0, 1, 2
_STATE_NAMES = {EXCLUSIVE: "exclusive", SHARED_READ: "shared-read",
                SHARED_MOD: "shared-modified"}

_enabled = False
#: classes registered by shared_state()/RaceTracked, instrumented the
#: moment the sanitizer arms: [(cls, only, exclude, mutating)]
_registry: list[tuple[type, frozenset | None, frozenset,
                      frozenset]] = []
#: cls -> (original __setattr__, original __getattribute__)
_originals: dict[type, tuple] = {}
#: serializes record transitions; snapshot held_lock_names() BEFORE
#: acquiring so the sanitizer's own lock never enters a lockset.
#: Always innermost + released before any other acquisition, so it
#: cannot close a lockdep cycle.
_lock = make_lock("racecheck.state")
#: every race observed this process (RaceError raises too, but a
#: dispatch thread's catch-all must not be able to swallow the
#: evidence) — reset() clears
_races: list["RaceError"] = []


class RaceError(RuntimeError):
    """Candidate lockset for a write-shared attribute went empty: two
    threads touched it with no common lock held.  Carries both access
    stacks (the racing pair)."""

    def __init__(self, cls_name: str, attr: str, prev, cur,
                 ever_held: frozenset):
        self.cls_name = cls_name
        self.attr = attr
        self.prev = prev          # (thread name, write?, stack)
        self.cur = cur
        self.ever_held = ever_held
        super().__init__(self._render())

    @staticmethod
    def _fmt(acc) -> str:
        thread, write, stack = acc
        kind = "write" if write else "read"
        frames = "\n".join(f"      {fn}:{ln} in {name}()"
                           for fn, ln, name in stack) or \
            "      <no frames captured>"
        return f"    {kind} by thread {thread!r}:\n{frames}"

    def _render(self) -> str:
        held = ", ".join(sorted(self.ever_held)) or "<none>"
        return (
            f"data race on {self.cls_name}.{self.attr}: no single "
            f"lock protects every access (locks ever held at an "
            f"access: {held})\n"
            f"  previous access:\n{self._fmt(self.prev)}\n"
            f"  racing access:\n{self._fmt(self.cur)}\n"
            f"  fix: take the owning make_lock() around both sites, "
            f"or mark a legitimate hand-off with "
            f"racecheck.transfer_ownership(obj)")


class _Rec:
    """Lockset state for one (object, attribute)."""

    __slots__ = ("owner", "state", "lockset", "ever", "last")

    def __init__(self, owner: int):
        self.owner = owner          # thread ident while EXCLUSIVE
        self.state = EXCLUSIVE
        self.lockset: frozenset | None = None
        self.ever: frozenset = frozenset()   # union, for the report
        #: (thread name, write?, stack) of the last SHARED access
        self.last = None


def _stack(skip: int = 3, depth: int = 5) -> tuple:
    """Cheap shallow stack: (file, line, func) tuples walked via
    sys._getframe — traceback.extract_stack would read source lines
    and is far too slow for a per-access path."""
    out = []
    try:
        f = sys._getframe(skip)
    except ValueError:
        return ()
    while f is not None and len(out) < depth:
        co = f.f_code
        out.append((co.co_filename, f.f_lineno, co.co_name))
        f = f.f_back
    return tuple(out)


def _note(obj, cls_name: str, name: str, write: bool,
          mutread: bool = False) -> None:
    d = object.__getattribute__(obj, "__dict__")
    recs = d.get(_RECS)
    tid = threading.get_ident()
    if recs is not None:
        rec = recs.get(name)
        # fast path, no lock: the single-threaded (init) phase.  A
        # racing transition under _lock at worst misses one lockset
        # refinement — the detector is approximate by design.
        if rec is not None and rec.state == EXCLUSIVE and \
                rec.owner == tid:
            return
    if mutread:
        # a `mutating` attribute read counts as a WRITE only from the
        # object's own methods — that is where `self._map[k] = v`
        # content mutation lives.  An external read (a test peeking a
        # PG table, a status scrape) declares itself stale-tolerant
        # by reading from outside: it neither refines the lockset nor
        # trips — the contract policed is "every MUTATOR holds the
        # guard", the GIL keeps bare dict reads tear-free.
        try:
            caller = sys._getframe(2)
            write = caller.f_locals.get("self") is obj
        except ValueError:
            write = False
        if not write:
            return
    held = held_lock_names()        # snapshot BEFORE our own lock
    with _lock:
        if recs is None:
            recs = d.setdefault(_RECS, {})
        rec = recs.get(name)
        if rec is None:
            recs[name] = _Rec(tid)
            return
        if rec.state == EXCLUSIVE:
            if rec.owner == tid:
                return
            # second thread: the attribute is published.  Candidate
            # lockset seeds from THIS access's held set.
            rec.state = SHARED_MOD if write else SHARED_READ
            rec.lockset = frozenset(held)
            rec.ever = rec.lockset
            rec.last = (threading.current_thread().name, write,
                        _stack())
            if write and not rec.lockset:
                self_err = RaceError(
                    cls_name, name,
                    ("<exclusive owner>", True, ()), rec.last,
                    rec.ever)
                _races.append(self_err)
                raise self_err
            return
        prev = rec.last
        held_f = frozenset(held)
        rec.lockset = rec.lockset & held_f
        rec.ever = rec.ever | held_f
        if write and rec.state == SHARED_READ:
            rec.state = SHARED_MOD
        cur = (threading.current_thread().name, write, _stack())
        rec.last = cur
        if rec.state == SHARED_MOD and not rec.lockset:
            err = RaceError(cls_name, name, prev, cur, rec.ever)
            _races.append(err)
            # re-seed so one bug reports once per racing PAIR, not
            # once per subsequent access forever
            rec.lockset = frozenset(held)
            raise err


def _slot(name: str) -> str:
    """Instance-dict slot a tracked attribute's value really lives in
    once its class is instrumented (the property shadows `name`)."""
    return f"__race_{name}"


def _tracked_property(cls_name: str, name: str,
                      mutating: bool) -> property:
    store = _slot(name)

    def fget(self):
        _note(self, cls_name, name, False, mutread=mutating)
        d = object.__getattribute__(self, "__dict__")
        try:
            return d[store]
        except KeyError:
            # instance built BEFORE enable() armed the class: its
            # value still lives under the plain name — adopt it into
            # the slot (under _lock: two readers racing the one-time
            # migration must not chase each other's pop) so
            # retro-instrumentation never orphans live daemon state
            with _lock:
                if store in d:
                    return d[store]
                if name in d:
                    d[store] = d.pop(name)
                    return d[store]
            raise AttributeError(name) from None

    def fset(self, value):
        _note(self, cls_name, name, True)
        d = object.__getattribute__(self, "__dict__")
        d.pop(name, None)           # retire any pre-arming value
        d[store] = value

    def fdel(self):
        _note(self, cls_name, name, True)
        d = object.__getattribute__(self, "__dict__")
        if store in d:
            del d[store]
        elif name in d:
            del d[name]
        else:
            raise AttributeError(name)
    return property(fget, fset, fdel)


def _instrument(cls: type, only: frozenset | None,
                exclude: frozenset, mutating: frozenset) -> None:
    """Two instrumentation shapes, chosen by cost:

    * ``only`` given (every production use): one data descriptor PER
      TRACKED NAME.  Untracked attribute traffic — method lookups,
      the other thirty fields of a daemon — stays on the C fast
      path; a __getattribute__ override here measurably slowed the
      whole tier-1 suite.
    * no ``only`` (track everything): the __getattribute__/__setattr__
      wrap, since the names aren't known up front."""
    if cls in _originals:
        return
    cls_name = cls.__name__
    if only is not None:
        saved = {n: cls.__dict__.get(n, _MISSING) for n in only}
        _originals[cls] = ("props", saved)
        for n in only:
            setattr(cls, n, _tracked_property(cls_name, n,
                                              n in mutating))
        return
    orig_set = cls.__setattr__
    orig_get = cls.__getattribute__
    _originals[cls] = ("wrap", (orig_set, orig_get))
    skip = exclude | {_RECS}

    def __setattr__(self, name, value):
        if name not in skip and not name.startswith("__"):
            _note(self, cls_name, name, True)
        orig_set(self, name, value)

    def __getattribute__(self, name):
        if name not in skip and not name.startswith("__") and \
                name in orig_get(self, "__dict__"):
            _note(self, cls_name, name, False,
                  mutread=name in mutating)
        return orig_get(self, name)

    cls.__setattr__ = __setattr__
    cls.__getattribute__ = __getattribute__


_MISSING = object()


def _quiet_property(name: str) -> property:
    """Replacement installed by disable(): keeps instances built
    while armed working (their values live in the mangled slot) but
    notes nothing.  Tests only — a never-armed process never gets
    any descriptor at all."""
    store = _slot(name)

    def fget(self):
        try:
            return object.__getattribute__(self, "__dict__")[store]
        except KeyError:
            raise AttributeError(name) from None

    def fset(self, value):
        object.__getattribute__(self, "__dict__")[store] = value
    return property(fget, fset)


def _deinstrument(cls: type) -> None:
    kind_orig = _originals.pop(cls, None)
    if kind_orig is None:
        return
    kind, orig = kind_orig
    if kind == "wrap":
        cls.__setattr__, cls.__getattribute__ = orig
        return
    # a pre-existing class-level default cannot be restored without
    # orphaning armed-era instance values living in the mangled slot:
    # the quiet property wins either way (tests only)
    for n in orig:
        setattr(cls, n, _quiet_property(n))


def shared_state(only=None, exclude=(), mutating=()):
    """Class decorator marking a daemon shared structure for race
    checking.

    ``only``     — track exactly these attribute names (the bounded
                   form for hot classes; omit to track every
                   instance-dict attribute).
    ``exclude``  — names never tracked (only meaningful without
                   ``only``).
    ``mutating`` — container-valued attributes whose READS from the
                   object's OWN methods count as writes
                   (``self._map[k] = v`` mutates through a read of
                   ``_map``); reads from outside the object (a test
                   peek, a status scrape) stay reads — an external
                   reader declares itself stale-tolerant.  Must be a
                   subset of the tracked names.

    When the `racecheck` option is off this registers the class and
    returns it UNTOUCHED — zero overhead, like make_lock returning a
    plain RLock."""
    only_f = frozenset(only) if only is not None else None
    exclude_f = frozenset(exclude)
    mutating_f = frozenset(mutating)

    def deco(cls):
        _registry.append((cls, only_f, exclude_f, mutating_f))
        if _enabled:
            _instrument(cls, only_f, exclude_f, mutating_f)
        return cls
    return deco


class RaceTracked:
    """Mixin form of shared_state() for hot classes: subclassing
    registers the subclass, with the tracked set read from the
    class-level ``RACE_TRACK`` tuple (and ``RACE_MUTATING`` for
    container attrs).  No ``RACE_TRACK`` = track everything."""

    RACE_TRACK: tuple = ()
    RACE_MUTATING: tuple = ()

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        only = frozenset(cls.RACE_TRACK) if cls.RACE_TRACK else None
        mutating = frozenset(cls.RACE_MUTATING)
        _registry.append((cls, only, frozenset(), mutating))
        if _enabled:
            _instrument(cls, only, frozenset(), mutating)


def transfer_ownership(obj, *attrs) -> None:
    """Declare a hand-off: the NEXT thread to touch `attrs` (all
    tracked attributes when none are named) becomes their exclusive
    owner, as if freshly constructed.  Call this where an object
    crosses threads by design — an op queued to a worker, a
    connection map rebuilt and published — so the hand-off is
    documented in code instead of suppressed in a baseline."""
    if not _enabled:
        return
    try:
        d = object.__getattribute__(obj, "__dict__")
    except AttributeError:
        return
    recs = d.get(_RECS)
    if not recs:
        return
    with _lock:
        for name in (attrs or list(recs)):
            recs.pop(name, None)


# ----------------------------------------------------------- lifecycle

def enabled() -> bool:
    return _enabled


def enable() -> None:
    """Arm the sanitizer: instrument every class registered so far
    (and every one registered after).  Idempotent.  Requires lockdep
    — without it make_lock hands out plain RLocks, held_lock_names()
    is always empty, and every guarded access would look like a
    race."""
    global _enabled
    if _enabled:
        return
    from .options import global_config
    if not global_config()["lockdep"]:
        raise RuntimeError(
            "racecheck requires lockdep: the candidate-lockset "
            "intersection reads lockdep's per-thread held set "
            "(set CEPH_TPU_LOCKDEP=1 / the `lockdep` option first)")
    _enabled = True
    for cls, only, exclude, mutating in _registry:
        _instrument(cls, only, exclude, mutating)


def disable() -> None:
    """Restore every instrumented class (tests only)."""
    global _enabled
    if not _enabled:
        return
    _enabled = False
    for cls in list(_originals):
        _deinstrument(cls)


def enable_if_configured() -> bool:
    """Arm when the `racecheck` option (env ``CEPH_TPU_RACECHECK``)
    is on — the conftest/daemon_main entry point.  Same parser as
    lockdep/jaxguard: the config env layer reads the option through
    Option.parse, so off/False/0/no all disable."""
    from .options import global_config
    if global_config()["racecheck"]:
        enable()
    return _enabled


def reset() -> None:
    """Drop accumulated race reports (tests)."""
    with _lock:
        _races.clear()


def races() -> list[RaceError]:
    """Every race observed since the last reset() — the evidence
    survives even when a daemon thread's catch-all ate the raise."""
    with _lock:
        return list(_races)


def stats() -> dict:
    """Registry/instrumentation accounting (smoke + tests)."""
    with _lock:
        return {"registered": len(_registry),
                "instrumented": len(_originals),
                "races": len(_races)}


def _arm_at_import() -> None:
    """Armed by the environment at import, as the device guard is.  The
    option without lockdep leaves it off with a warning: raising here
    would stop every module that imports this one from importing."""
    from .options import global_config
    cfg = global_config()
    if not cfg["racecheck"]:
        return
    if not cfg["lockdep"]:
        warnings.warn("racecheck is set without lockdep: left off "
                      "(set CEPH_TPU_LOCKDEP=1 as well)", RuntimeWarning,
                      stacklevel=2)
        return
    enable()


_arm_at_import()
