"""Admin socket: per-daemon out-of-band command endpoint.

The reference serves `ceph daemon <name> <cmd>` over a unix-domain
socket with a tiny length-prefixed JSON protocol
(ref: src/common/admin_socket.cc — AdminSocket::entry accept loop,
execute_command; registration via register_command).  Same here:
newline-delimited JSON request {"prefix": ...} -> JSON reply
{"rc": int, "out": any} over a SOCK_STREAM unix socket.

Daemons register command handlers; `admin_command()` is the client
(the `ceph daemon` CLI analogue).

The port's copy of `ceph_tpu.common.admin_socket`, whole, plus
`register_obs_commands` (the op tracker's dumps, which the reference
keeps in common/obs.py); the port's mon and OSD daemons register their
commands on it (`start_admin_socket`).
"""
from __future__ import annotations

import json
import os
import socket
import threading
from typing import Any, Callable

from .log import dout

Handler = Callable[[dict], "tuple[int, Any]"]


class AdminSocket:
    """(ref: src/common/admin_socket.h:44)."""

    def __init__(self, path: str):
        self.path = path
        self._handlers: dict[str, tuple[str, Handler]] = {}
        self._listener: socket.socket | None = None
        self._running = False
        self.register("help", "list registered commands", self._help)

    def register(self, prefix: str, help_text: str,
                 fn: Handler) -> None:
        """(ref: AdminSocket::register_command)."""
        self._handlers[prefix] = (help_text, fn)

    def _help(self, _cmd: dict):
        return 0, {p: h for p, (h, _f) in sorted(self._handlers.items())}

    # -- server ----------------------------------------------------------
    def start(self) -> None:
        if os.path.exists(self.path):
            os.unlink(self.path)
        self._listener = socket.socket(socket.AF_UNIX,
                                       socket.SOCK_STREAM)
        self._listener.bind(self.path)
        self._listener.listen(8)
        self._running = True
        t = threading.Thread(target=self._accept_loop,
                             name=f"asok-{os.path.basename(self.path)}",
                             daemon=True)
        t.start()

    def shutdown(self) -> None:
        self._running = False
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        try:
            os.unlink(self.path)
        except OSError:
            pass

    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            try:
                self._serve_one(conn)
            except Exception:
                import traceback
                dout("asok", 1).write("admin socket error: %s",
                                      traceback.format_exc())
            finally:
                try:
                    conn.close()
                except OSError:
                    pass

    def _serve_one(self, conn: socket.socket) -> None:
        buf = b""
        while b"\n" not in buf:
            chunk = conn.recv(65536)
            if not chunk:
                return
            buf += chunk
        try:
            cmd = json.loads(buf.split(b"\n", 1)[0])
        except json.JSONDecodeError:
            conn.sendall(json.dumps(
                {"rc": -22, "out": "invalid json"}).encode() + b"\n")
            return
        prefix = cmd.get("prefix", "")
        entry = self._handlers.get(prefix)
        if entry is None:
            rc, out = -22, f"unknown command {prefix!r}; try 'help'"
        else:
            try:
                rc, out = entry[1](cmd)
            except Exception as ex:          # handler bug: report it
                rc, out = -22, f"{type(ex).__name__}: {ex}"
        conn.sendall(json.dumps({"rc": rc, "out": out},
                                default=str).encode() + b"\n")


def register_obs_commands(asok: AdminSocket, tracker,
                          tracer=None) -> None:
    """The op tracker's dumps (and, given a tracer, its finished spans)
    on a daemon's admin socket (ref: OSD.cc / Monitor.cc asok
    registration of dump_ops_in_flight and friends; the reference keeps
    this in common/obs.py)."""
    asok.register("dump_ops_in_flight", "ops currently executing",
                  lambda c: (0, tracker.dump_in_flight()))
    asok.register("dump_historic_ops", "recently completed ops",
                  lambda c: (0, tracker.dump_historic()))
    asok.register("dump_historic_slow_ops",
                  "recently completed ops over the complaint age",
                  lambda c: (0, tracker.dump_historic_slow()))
    asok.register("dump_blocked_ops", "ops over the complaint age",
                  lambda c: (0, tracker.slow_ops()))
    if tracer is not None:
        asok.register("dump_traces", "finished blkin spans "
                      "(optionally trace_id=...)",
                      lambda c: (0, tracer.dump(c.get("trace_id"))))


def admin_command(path: str, cmd: dict | str,
                  timeout: float = 10.0) -> tuple[int, Any]:
    """Client side (`ceph daemon <sock> <cmd>` analogue)."""
    if isinstance(cmd, str):
        cmd = {"prefix": cmd}
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(timeout)
    try:
        s.connect(path)
        s.sendall(json.dumps(cmd).encode() + b"\n")
        buf = b""
        while b"\n" not in buf:
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
        rep = json.loads(buf.split(b"\n", 1)[0])
        return rep["rc"], rep["out"]
    finally:
        s.close()


def main(argv=None) -> int:
    """`ceph daemon <sock> <cmd...>` analogue."""
    import sys
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print("usage: admin_socket <sock-path> <command...> "
              "[key=value ...]", file=sys.stderr)
        return 2
    path, words = argv[0], argv[1:]
    cmd: dict = {"prefix": " ".join(w for w in words if "=" not in w)}
    for w in words:
        if "=" in w:
            k, v = w.split("=", 1)
            cmd[k] = v
    rc, out = admin_command(path, cmd)
    print(json.dumps(out, indent=1, default=str))
    return 0 if rc == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
