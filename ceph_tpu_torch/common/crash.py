"""Daemon crash capture: unhandled exception -> crash metadata ->
cluster crash table (ref: src/pybind/mgr/crash/module.py ingest + the
ceph-crash spool agent src/ceph-crash.in).

Every daemon installs a CrashReporter: when an unhandled exception
escapes a tick, a dispatch thread, or the process itself, the
reporter serializes it into a crash-metadata dict (crash_id =
timestamp+entity, backtrace, entity name/type, version, process args)
and posts it to the cluster's crash table (`crash post` through the
mon — the mgr crash module's ingest analogue).  When the cluster is
unreachable the report is SPOOLED to a crash dir
(`<crash_dir>/<crash_id>/meta.json`, the reference's
/var/lib/ceph/crash layout) and drained on the daemon's next boot;
the crash table dedups by crash_id, so spool+post double delivery
still lands exactly one report.

The port's copy of `ceph_tpu.common.crash`, whole: the same metadata
(crash_id, timestamp, backtrace, version, process args), the spool
layout, the drain, the ack tracking, the repeat-signature throttle and
the process hooks.
"""
from __future__ import annotations

import itertools
import json
import os
import re
import sys
import time
import traceback

from .log import dout

#: crash metadata format version (bump when adding fields)
CRASH_META_VERSION = 1

#: filename-safe crash_id (ISO stamps carry ':' and '.')
_SAFE = re.compile(r"[^A-Za-z0-9_.-]")

#: `File "/long/host/path/mod.py"` -> `File "mod.py"` (telemetry's
#: no-raw-paths anonymization contract)
_TB_PATH = re.compile(r'File "([^"]*[/\\])([^"/\\]+)"')

#: directory prefix of any absolute path — the traceback's final line
#: is the exception MESSAGE, and OSError et al. embed the offending
#: path there ("[Errno 2] ...: '/var/lib/.../store'")
_ANY_PATH = re.compile(r"(?:[A-Za-z]:)?(?:[\\/][\w.+~-]+)+[\\/]")


def utc_iso(stamp: float) -> str:
    """ISO-8601 UTC with microseconds (the reference crash module's
    timestamp format)."""
    frac = int(round((stamp - int(stamp)) * 1e6))
    if frac >= 1_000_000:           # float rounding at a second edge
        frac -= 1_000_000
        stamp += 1.0
    return time.strftime("%Y-%m-%dT%H:%M:%S",
                         time.gmtime(stamp)) + f".{frac:06d}Z"


def crash_meta(entity: str, exc: BaseException,
               stamp: float | None = None,
               argv: list[str] | None = None) -> dict:
    """Serialize an exception into the crash-metadata dict the crash
    table stores (ref: the JSON meta ceph daemons dump via
    generate_crash_dump and mgr/crash validates on `crash post`)."""
    stamp = time.time() if stamp is None else stamp
    iso = utc_iso(stamp)
    tb = traceback.format_exception(type(exc), exc, exc.__traceback__)
    try:
        from importlib.metadata import version as _v
        version = _v("ceph-tpu")
    except Exception:           # uninstalled tree: version best-effort
        version = "0.3.0-dev"
    return {
        "crash_id": f"{iso}_{entity}",
        "timestamp": iso,
        "stamp": stamp,
        "entity_name": entity,
        "entity_type": entity.split(".", 1)[0],
        "backtrace": [ln.rstrip("\n") for ln in tb],
        "exc_type": type(exc).__name__,
        "exc_msg": str(exc),
        "version": version,
        "process_args": list(sys.argv if argv is None else argv),
        "meta_version": CRASH_META_VERSION,
        "archived": None,
    }


def sanitize_backtrace(lines: list[str]) -> list[str]:
    """Strip directory components from backtrace frames AND from any
    path embedded in the exception-message line — telemetry ships
    stacks but never raw filesystem paths (the anonymization
    contract; ref: the reference telemetry module's crash sanitizer)."""
    return [_ANY_PATH.sub("", _TB_PATH.sub(r'File "\2"', ln))
            for ln in lines]


class CrashReporter:
    """Per-daemon capture + spool + post agent.

    `post` is a best-effort callable(meta) that ships the report to
    the cluster (a mon command send); it may raise or silently fail —
    the spool (when a crash_dir is configured) is the durable copy
    until `mark_delivered` removes it on the cluster's ack.
    """

    #: identical-signature captures inside this window are dropped —
    #: a persistently failing tick in a survive-loop daemon must not
    #: storm the crash table with one report per second
    REPEAT_WINDOW = 60.0

    def __init__(self, entity: str, crash_dir: str | None = None,
                 post=None, clock=time.time):
        self.entity = entity
        self.crash_dir = crash_dir or None
        self.post = post
        self.clock = clock
        #: crash_ids captured by this process (tests/ops introspection)
        self.captured: list[str] = []
        self._last_sig: tuple | None = None
        self._last_stamp = 0.0
        # wire posts awaiting the cluster's ack: tid -> crash_id
        self._tids: dict[int, str] = {}
        self._tid_gen = itertools.count(1)

    # ------------------------------------------------------ ack tracking
    # (shared by every daemon that posts over the command channel: the
    #  sender allocates a tid per post, feeds the MMonCommandAck back
    #  through on_ack, and the matching spool copy is retired)
    def alloc_tid(self, crash_id: str) -> int:
        """Tid for one wire post; pair with on_ack(tid, result)."""
        tid = next(self._tid_gen)
        self._tids[tid] = crash_id
        return tid

    def forget_tid(self, tid: int) -> None:
        """The post was never sent: no ack is coming."""
        self._tids.pop(tid, None)

    def on_ack(self, tid: int, result: int) -> bool:
        """Route a command ack: True iff the tid was one of our posts.
        A zero result retires the spool copy; any other result leaves
        it for the next drain."""
        cid = self._tids.pop(tid, None)
        if cid is not None and result == 0:
            self.mark_delivered(cid)
        return cid is not None

    # ---------------------------------------------------------- capture
    def capture(self, exc: BaseException) -> dict:
        """Serialize, spool, and post one crash.  Never raises — this
        runs on already-failing paths."""
        sig = (type(exc).__name__, str(exc))
        now = self.clock()
        if sig == self._last_sig and \
                0 <= now - self._last_stamp < self.REPEAT_WINDOW:
            return {}
        self._last_sig, self._last_stamp = sig, now
        try:
            meta = crash_meta(self.entity, exc, stamp=self.clock())
        except Exception as ex:
            dout("crash", 0).write("%s: crash meta build failed: %s",
                                   self.entity, ex)
            return {}
        self.captured.append(meta["crash_id"])
        dout("crash", 0).write("%s: crashed — %s: %s (crash_id %s)",
                               self.entity, meta["exc_type"],
                               meta["exc_msg"], meta["crash_id"])
        self.spool(meta)                 # durable first
        if self.post is not None:
            try:
                self.post(meta)
            except Exception as ex:      # cluster unreachable: spooled
                dout("crash", 1).write(
                    "%s: crash post failed (%s); report spooled",
                    self.entity, ex)
        return meta

    # ------------------------------------------------------------ spool
    def _spool_path(self, crash_id: str) -> str:
        return os.path.join(self.crash_dir, _SAFE.sub("_", crash_id),
                            "meta.json")

    def spool(self, meta: dict) -> None:
        if self.crash_dir is None or not meta:
            return
        try:
            path = self._spool_path(meta["crash_id"])
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(meta, f, indent=1, sort_keys=True)
            os.replace(tmp, path)        # crash-safe: whole file or none
        except OSError as ex:
            dout("crash", 0).write("%s: crash spool failed: %s",
                                   self.entity, ex)

    def spooled(self) -> list[dict]:
        """Reports awaiting delivery (drained on boot, oldest first)."""
        if self.crash_dir is None or not os.path.isdir(self.crash_dir):
            return []
        out = []
        for d in sorted(os.listdir(self.crash_dir)):
            path = os.path.join(self.crash_dir, d, "meta.json")
            try:
                with open(path) as f:
                    out.append(json.load(f))
            except (OSError, ValueError):
                continue                 # half-written spool: skip
        return out

    def drain(self) -> int:
        """Re-post every spooled report (next-boot delivery; the crash
        table dedups so this is safe to repeat).  Spool files stay
        until the cluster acks via mark_delivered."""
        n = 0
        if self.post is None:
            return n
        for meta in self.spooled():
            try:
                self.post(meta)
                n += 1
            except Exception as ex:
                dout("crash", 1).write("%s: spool drain post failed: %s",
                                       self.entity, ex)
        return n

    def mark_delivered(self, crash_id: str) -> None:
        """The cluster acked this report: drop the spool copy."""
        if self.crash_dir is None:
            return
        path = self._spool_path(crash_id)
        try:
            os.remove(path)
            os.rmdir(os.path.dirname(path))
        except OSError:
            pass                         # never spooled / already gone

    # ------------------------------------------------------ process hook
    def install_excepthook(self) -> None:
        """Capture exceptions that escape the whole process/threads
        (daemon_main's last line of defense), then chain to the
        previous hooks."""
        import threading
        prev_sys = sys.excepthook
        prev_thread = threading.excepthook

        def _hook(exc_type, exc, tb):
            if exc is not None and not isinstance(exc, KeyboardInterrupt):
                self.capture(exc)
            prev_sys(exc_type, exc, tb)

        def _thread_hook(args):
            if args.exc_value is not None and \
                    not isinstance(args.exc_value, KeyboardInterrupt):
                self.capture(args.exc_value)
            prev_thread(args)

        sys.excepthook = _hook
        threading.excepthook = _thread_hook
