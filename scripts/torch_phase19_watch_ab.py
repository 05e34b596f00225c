"""Phase 19 of chip_smoke.py alone on the card, with its watch legs or
without them: what the four watcher clients cost the recovery.

    python3 scripts/torch_phase19_watch_ab.py [nowatch]

Builds the kernels and runs `chip_smoke.cluster_phase` as the smoke
does; with `nowatch`, 19 (f)'s snapshot, refusals and object classes run
with one extra client (the lock needs two) and no watcher clients, and
the after-clean leg checks only the s19 reads and the clones, and the
rbd leg (which holds a lock through a watcher client) is left out.  Prints
the phase's lines, among them the time from `osd out` to clean.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402


def before_kill_nowatch(self, victim: int) -> None:
    m, pid = self.c.mon.osdmap, self.rep.pid
    held = [n for n in self.names if victim in m.pg_to_up_acting_osds(
        m.object_locator_to_pg(n, pid))[2]]
    self.over = (held + [n for n in self.names
                         if n not in held])[:cs.SNAP_OVERWRITES]
    self.new = {n: self.rng.bytes(cs.REPAIR_OBJECT) for n in self.over}
    self.gone = [n for n in self.names if n not in self.over][-1]
    self.rolled = self.over[-1]
    self.rolled_data = self.rep.objs[self.rolled]
    self.late = self.rng.bytes(cs.REPAIR_OBJECT)
    self.snapshot()
    self.refusals()
    self.clients = [self.r, self.c.rados(timeout=cs.CLUSTER_TIMEOUT_S)]
    self.object_classes()
    self.clients[1].shutdown()
    self.out["notify"] = {"p50_ms": 0.0, "p99_ms": 0.0, "watches": 0}


def after_clean_nowatch(self) -> None:
    self._check_s19("phase 19 (f)")
    self.out["clones_after"] = self._clone_objects("phase 19 (f)")
    self.out.update({"relinger_s": 0.0, "dead_notify_s": 0.0,
                     "moved": {"objects": 0, "watches": 0, "replies": 0,
                               "timed_out": []}})


def main(argv) -> int:
    from ceph_tpu_torch.ec.kernels import _build

    _build.build("gf_matmul", "crush_rule")
    name = cs.card()
    print(name)
    if argv == ["nowatch"]:
        cs.SnapLeg.before_kill = before_kill_nowatch
        cs.SnapLeg.after_clean = after_clean_nowatch
        cs.SnapLeg.close_clients = lambda self: None
        cs.RbdLeg.before_kill = cs.RbdLeg.after_clean = lambda self: None
        cs.print_rbd = lambda *a: None
    t0 = time.monotonic()
    cs.cluster_phase(name, "cuda")
    print(f"phase 19 {argv or ['with watches']} done in "
          f"{time.monotonic() - t0:.1f} s on {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
