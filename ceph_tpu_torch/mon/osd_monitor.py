"""OSDMonitor: the osdmap PaxosService — command engine + map authority.

Port of the reference's map-mutation path (ref: src/mon/OSDMonitor.cc):
commands split into *preprocess* (read-only, answered from the current
map) and *prepare* (mutations accumulated into ``pending_inc`` and
committed through Paxos).  The production entry point that makes the EC
plugins real is here: ``osd pool create ... erasure <profile>`` →
prepare_new_pool (OSDMonitor.cc:6333) → crush_rule_create_erasure
(:6458) → plugin ``create_rule`` — the same call chain the reference
drives through the mon.

Commands take cmdmap dicts ({"prefix": "osd pool create", ...}) like
the reference mon's parsed cmdmap; returns are (retcode, outs, outb).

The port's copy of `ceph_tpu.mon.osd_monitor`.  The one difference: the
monitor builds every plugin (to validate a profile, size a pool and
create its CRUSH rule) on its `device` (cuda unless the caller passes
`device="cpu"`), through the port's registry.
"""
from __future__ import annotations

import copy

from ..common.log import dout
from ..crush.wrapper import CrushWrapper
from ..ec import registry as ec_registry
from ..osd.osdmap import CEPH_OSD_IN, CEPH_OSD_UP, Incremental, OSDMap
from ..osd.types import (PG, PGPool, POOL_TYPE_ERASURE,
                         POOL_TYPE_REPLICATED)
from ..msg import encoding as wire
from .paxos import Paxos, PaxosService
from .store import StoreTransaction

EEXIST, ENOENT, EINVAL, EPERM, EALREADY, EBUSY = 17, 2, 22, 1, 114, 16
EOPNOTSUPP = 95

# the reference's default profile (osd_pool_default_erasure_code_profile,
# src/common/options.cc) is jerasure k=2 m=1; ours defaults to the tpu
# plugin — the batched device coder (K1) — with the same geometry
DEFAULT_EC_PROFILE = {"plugin": "tpu", "k": "2", "m": "1",
                      "crush-failure-domain": "host"}


class OSDMonitor(PaxosService):
    """(ref: src/mon/OSDMonitor.h:537)."""

    def __init__(self, paxos: Paxos, initial_map: OSDMap | None = None,
                 initial_wrapper: CrushWrapper | None = None,
                 device=None):
        super().__init__("osdmap", paxos)
        #: where the plugins this service builds live (None -> cuda)
        self.device = device
        self.osdmap = OSDMap()
        self.wrapper = CrushWrapper()      # names for osdmap.crush
        self._initial_map = initial_map
        self._initial_wrapper = initial_wrapper
        self.pending_inc = Incremental()
        self._pending_wrapper: CrushWrapper | None = None
        self._bootstrap: tuple | None = None

    # ------------------------------------------------------- paxos hooks
    def create_initial(self) -> None:
        """(ref: OSDMonitor.cc:220 create_initial)."""
        if self._initial_map is not None:
            m = self._initial_map
            w = self._initial_wrapper or CrushWrapper()
            w.crush = m.crush
        else:
            m = OSDMap()
            m.epoch = 1
            w = CrushWrapper.build_flat(0)
            m.crush = w.crush
        self.pending_inc = Incremental(epoch=m.epoch)
        self._bootstrap = (m, w)

    def encode_pending(self, tx: StoreTransaction) -> None:
        """Write the inc + resulting full map at the new epoch
        (ref: OSDMonitor.cc:1350 encode_pending)."""
        if getattr(self, "_bootstrap", None) is not None:
            m, w = self._bootstrap
            self._bootstrap = None
            e = m.epoch
            self.put_version(tx, f"inc_{e}", None)
            self.put_version(tx, f"full_{e}", wire.encode((m, w)))
            self.put_version(tx, "last_committed", e)
            self.put_version(tx, "first_committed", e)
            return
        if self._is_pending_empty():
            return
        e = self.pending_inc.epoch
        nm = self.osdmap.clone()
        inc = copy.deepcopy(self.pending_inc)
        nm.apply_incremental(inc)
        w = self._pending_wrapper or self.wrapper
        w = copy.deepcopy(w)
        w.crush = nm.crush
        self.put_version(tx, f"inc_{e}", wire.encode(inc))
        self.put_version(tx, f"full_{e}", wire.encode((nm, w)))
        self.put_version(tx, "last_committed", e)
        # trim history beyond mon_min_osdmap_epochs
        # (ref: OSDMonitor.cc get_trim_to / PaxosService maybe_trim)
        from ..common.options import global_config
        keep = global_config()["mon_min_osdmap_epochs"]
        first = self.get_first_committed() or 1
        if e - first > keep:
            new_first = e - keep
            for v in range(first, new_first):
                tx.erase(self.service_name, f"inc_{v}")
                tx.erase(self.service_name, f"full_{v}")
            self.put_version(tx, "first_committed", new_first)

    def update_from_paxos(self) -> None:
        """Load the latest committed full map
        (ref: OSDMonitor.cc:370 update_from_paxos)."""
        e = self.get_last_committed()
        if e and e != self.osdmap.epoch:
            blob = self.get_version(f"full_{e}")
            self.osdmap, self.wrapper = wire.decode(blob)

    def create_pending(self) -> None:
        self.pending_inc = Incremental(epoch=self.osdmap.epoch + 1)
        self._pending_wrapper = None

    def _is_pending_empty(self) -> bool:
        blank = Incremental(epoch=self.pending_inc.epoch)
        return self.pending_inc == blank and self._pending_wrapper is None

    # ------------------------------------------------------ map history
    def get_full_map(self, epoch: int = 0) -> OSDMap | None:
        e = epoch or self.get_last_committed()
        blob = self.get_version(f"full_{e}")
        return wire.decode(blob)[0] if blob is not None else None

    def get_incremental(self, epoch: int) -> Incremental | None:
        blob = self.get_version(f"inc_{epoch}")
        return wire.decode(blob) if blob is not None else None

    # ------------------------------------------------------------- crush
    def _get_pending_crush(self) -> CrushWrapper:
        """Working copy for this command's crush mutation
        (ref: OSDMonitor.cc:383 _get_pending_crush)."""
        if self._pending_wrapper is not None:
            return self._pending_wrapper
        w = copy.deepcopy(self.wrapper)
        if self.pending_inc.new_crush is not None:
            w.crush = self.pending_inc.new_crush
        return w

    def _commit_pending_crush(self, w: CrushWrapper) -> None:
        self._pending_wrapper = w
        self.pending_inc.new_crush = w.crush

    # -------------------------------------------------------- ec profile
    def _get_profile(self, name: str) -> dict | None:
        """Pending-over-committed profile lookup, with the implicit
        'default' (ref: OSDMonitor.cc get_erasure_code_profile)."""
        if name in self.pending_inc.new_erasure_code_profiles:
            return self.pending_inc.new_erasure_code_profiles[name]
        if name in self.osdmap.erasure_code_profiles:
            return self.osdmap.erasure_code_profiles[name]
        if name == "default":
            return dict(DEFAULT_EC_PROFILE)
        return None

    def get_erasure_code(self, profile_name: str):
        """profile -> plugin instance (ref: OSDMonitor.cc:6495)."""
        profile = self._get_profile(profile_name)
        if profile is None:
            raise KeyError(f"no erasure-code-profile {profile_name!r}")
        plugin = profile.get("plugin")
        if not plugin:
            raise ValueError(
                f"profile {profile_name!r} has no plugin= entry")
        return ec_registry.factory(plugin, profile, device=self.device)

    def crush_rule_create_erasure(self, name: str,
                                  profile_name: str) -> int:
        """(ref: OSDMonitor.cc:6458)."""
        rid = self.wrapper.get_rule_id(name)
        if rid >= 0:
            return rid
        newcrush = self._get_pending_crush()
        rid = newcrush.get_rule_id(name)
        if rid >= 0:
            self._commit_pending_crush(newcrush)
            return rid
        ec = self.get_erasure_code(profile_name)
        rid = ec.create_rule(name, newcrush)
        self._commit_pending_crush(newcrush)
        return rid

    # -------------------------------------------------------- pool create
    def _prepare_pool_size(self, pool_type: int, profile_name: str,
                           repl_size: int) -> tuple[int, int]:
        """(size, min_size) (ref: OSDMonitor.cc:6657)."""
        if pool_type == POOL_TYPE_REPLICATED:
            size = repl_size or 3
            return size, max(1, size - size // 2)
        ec = self.get_erasure_code(profile_name)
        size = ec.get_chunk_count()
        k = ec.get_data_chunk_count()
        m = ec.get_coding_chunk_count()
        return size, k + min(1, m - 1)

    def prepare_new_pool(self, name: str, pg_num: int, pool_type: int,
                         erasure_code_profile: str = "",
                         crush_rule_name: str = "",
                         repl_size: int = 0) -> tuple[int, str]:
        """(ref: OSDMonitor.cc:6333 prepare_new_pool / :6849
        prepare_command pool create path)."""
        if name in self.osdmap.pool_names.values() or \
                name in self.pending_inc.new_pool_names.values():
            return -EEXIST, f"pool '{name}' already exists"
        if pool_type == POOL_TYPE_ERASURE:
            profile = erasure_code_profile or "default"
            if self._get_profile(profile) is None:
                return -ENOENT, \
                    f"erasure-code-profile {profile} does not exist"
            rule_name = crush_rule_name or name
            try:
                rule = self.crush_rule_create_erasure(rule_name, profile)
            except (KeyError, ValueError) as ex:
                return -EINVAL, str(ex)
        else:
            profile = ""
            if crush_rule_name:
                rule = self.wrapper.get_rule_id(crush_rule_name)
                if rule < 0:
                    return -ENOENT, \
                        f"crush rule {crush_rule_name} does not exist"
            else:
                # first replicated rule (ref: get_osd_pool_default_
                # crush_replicated_ruleset)
                rule = next(
                    (i for i, r in enumerate(self.osdmap.crush.rules)
                     if r is not None and r.mask.type ==
                     POOL_TYPE_REPLICATED), -1)
                if rule < 0:
                    return -ENOENT, "no default replicated crush rule"
        try:
            size, min_size = self._prepare_pool_size(
                pool_type, profile, repl_size)
        except (KeyError, ValueError) as ex:
            return -EINVAL, str(ex)
        pool_id = max([self.osdmap.pool_max] +
                      list(self.pending_inc.new_pools)) + 1
        crush = self._pending_wrapper.crush if self._pending_wrapper \
            else self.osdmap.crush
        ruleset = crush.rules[rule].mask.ruleset
        self.pending_inc.new_pools[pool_id] = PGPool(
            type=pool_type, size=size, min_size=min_size,
            crush_rule=ruleset, pg_num=pg_num, pgp_num=pg_num,
            erasure_code_profile=profile)
        self.pending_inc.new_pool_names[pool_id] = name
        dout("mon", 10).write("prepare_new_pool %s id %d rule %d",
                              name, pool_id, rule)
        return 0, f"pool '{name}' created"

    # ------------------------------------------------------------ lookup
    def _pool_by_name(self, name: str) -> int | None:
        for pid, n in self.osdmap.pool_names.items():
            if n == name:
                return pid
        return None

    def _resolve_osd(self, spec) -> int | None:
        if isinstance(spec, int):
            osd = spec
        else:
            s = str(spec)
            osd = int(s[4:] if s.startswith("osd.") else s)
        return osd if 0 <= osd < self.osdmap.max_osd else None

    # ---------------------------------------------------------- commands
    def preprocess_command(self, cmdmap: dict
                           ) -> tuple[int, str, object] | None:
        """Read-only commands (ref: OSDMonitor.cc:759
        preprocess_command); returns (r, outs, outb), or None when the
        command is not a read command (caller routes to prepare)."""
        prefix = cmdmap.get("prefix", "")
        m = self.osdmap
        if prefix == "osd stat":
            n_up = sum(1 for o in range(m.max_osd) if m.is_up(o))
            n_in = sum(1 for o in range(m.max_osd) if m.is_in(o))
            n = sum(1 for o in range(m.max_osd) if m.exists(o))
            outs = (f"e{m.epoch}: {n} osds: {n_up} up, {n_in} in")
            return 0, outs, {"epoch": m.epoch, "num_osds": n,
                             "num_up_osds": n_up, "num_in_osds": n_in}
        if prefix == "osd getmap":
            epoch = int(cmdmap.get("epoch", 0))
            full = self.get_full_map(epoch)
            if full is None:
                return -ENOENT, f"there is no map for epoch {epoch}", None
            return 0, f"got osdmap epoch {full.epoch}", full
        if prefix == "osd ls":
            osds = [o for o in range(m.max_osd) if m.exists(o)]
            return 0, "\n".join(str(o) for o in osds), osds
        if prefix == "osd dump":
            return 0, "", self._dump()
        if prefix == "osd tree":
            return 0, self._tree_text(), None
        if prefix == "osd erasure-code-profile ls":
            names = sorted(set(m.erasure_code_profiles) | {"default"})
            return 0, "\n".join(names), names
        if prefix == "osd erasure-code-profile get":
            name = cmdmap.get("name", "")
            p = self._get_profile(name)
            if p is None:
                return -ENOENT, f"unknown erasure code profile '{name}'", \
                    None
            outs = "\n".join(f"{k}={v}" for k, v in sorted(p.items()))
            return 0, outs, p
        if prefix == "osd pool ls":
            names = [m.pool_names[p] for p in sorted(m.pools)]
            return 0, "\n".join(names), names
        if prefix == "osd pool get":
            pid = self._pool_by_name(cmdmap.get("pool", ""))
            if pid is None:
                return -ENOENT, \
                    f"unrecognized pool '{cmdmap.get('pool')}'", None
            pool = m.pools[pid]
            var = cmdmap.get("var", "")
            vals = {"size": pool.size, "min_size": pool.min_size,
                    "pg_num": pool.pg_num, "pgp_num": pool.pgp_num,
                    "crush_rule": pool.crush_rule,
                    "erasure_code_profile": pool.erasure_code_profile}
            if var not in vals:
                return -EINVAL, f"invalid pool variable {var}", None
            return 0, f"{var}: {vals[var]}", vals[var]
        if prefix == "pg map":
            pgid = cmdmap.get("pgid", "")
            pool_s, _, ps_s = str(pgid).partition(".")
            pg = PG(int(pool_s), int(ps_s, 16))
            up, up_p, acting, acting_p = m.pg_to_up_acting_osds(pg)
            return 0, (f"osdmap e{m.epoch} pg {pgid} -> up {up} "
                       f"acting {acting}"), \
                {"up": up, "up_primary": up_p, "acting": acting,
                 "acting_primary": acting_p}
        return None

    def prepare_command(self, cmdmap: dict) -> tuple[int, str, object]:
        """Mutating commands — stage into pending_inc; caller proposes
        (ref: OSDMonitor.cc:6849 prepare_command)."""
        prefix = cmdmap.get("prefix", "")
        m = self.osdmap
        if prefix == "osd setmaxosd":
            n = int(cmdmap["newmax"])
            self.pending_inc.new_max_osd = n
            return 0, f"set new max_osd = {n}", None
        if prefix == "osd pool create":
            name = cmdmap["pool"]
            pg_num = int(cmdmap.get("pg_num", 0)) or 32
            ptype = {"replicated": POOL_TYPE_REPLICATED,
                     "erasure": POOL_TYPE_ERASURE}.get(
                cmdmap.get("pool_type", "replicated"))
            if ptype is None:
                return -EINVAL, \
                    f"unknown pool type {cmdmap.get('pool_type')}", None
            r, outs = self.prepare_new_pool(
                name, pg_num, ptype,
                erasure_code_profile=cmdmap.get(
                    "erasure_code_profile", ""),
                crush_rule_name=cmdmap.get("rule", ""),
                repl_size=int(cmdmap.get("size", 0)))
            return r, outs, None
        if prefix == "osd pool delete":
            pid = self._pool_by_name(cmdmap.get("pool", ""))
            if pid is None:
                return -ENOENT, "pool does not exist", None
            if cmdmap.get("yes_i_really_really_mean_it") not in (
                    True, "true", "--yes-i-really-really-mean-it"):
                return -EPERM, \
                    ("WARNING: this will PERMANENTLY DESTROY all data "
                     "in the pool; pass yes_i_really_really_mean_it "
                     "to proceed"), None
            self.pending_inc.old_pools.append(pid)
            return 0, f"pool '{cmdmap['pool']}' removed", None
        if prefix == "osd pool selfmanaged-snap create":
            # allocate a snapid the CLIENT manages (ref:
            # OSDMonitor's selfmanaged_snap path /
            # rados_ioctx_selfmanaged_snap_create): snap_seq bumps,
            # pool.snaps does NOT record it — the snapc travels with
            # client IO instead
            pid = self._pool_by_name(cmdmap.get("pool", ""))
            if pid is None:
                return -ENOENT, "pool does not exist", None
            pool = self.pending_inc.new_pools.get(pid) or \
                copy.deepcopy(m.pools[pid])
            if pool.is_erasure():
                return -EOPNOTSUPP, \
                    "snapshots on erasure-coded pools are not " \
                    "supported here", None
            pool.snap_seq += 1
            self.pending_inc.new_pools[pid] = pool
            return 0, "", pool.snap_seq
        if prefix == "osd pool selfmanaged-snap rm":
            pid = self._pool_by_name(cmdmap.get("pool", ""))
            if pid is None:
                return -ENOENT, "pool does not exist", None
            # record removal so no future SnapContext covers the id
            # (clone trimming stays lazy, like a never-running snap
            # trimmer)
            sid = int(cmdmap.get("snapid", 0))
            if sid > 0:
                pool = self.pending_inc.new_pools.get(pid) or \
                    copy.deepcopy(m.pools[pid])
                pool.removed_snaps = sorted(
                    set(pool.removed_snaps) | {sid})
                self.pending_inc.new_pools[pid] = pool
            return 0, "", None
        if prefix in ("osd pool mksnap", "osd pool rmsnap"):
            # pool snapshots (ref: OSDMonitor.cc prepare_command
            # "osd pool mksnap" -> pg_pool_t::add_snap, snap_seq bump)
            pid = self._pool_by_name(cmdmap.get("pool", ""))
            if pid is None:
                return -ENOENT, "pool does not exist", None
            snap = cmdmap.get("snap", "")
            if not snap:
                return -EINVAL, "missing snap name", None
            pool = self.pending_inc.new_pools.get(pid) or \
                copy.deepcopy(m.pools[pid])
            if prefix == "osd pool mksnap":
                if pool.is_erasure():
                    return -EOPNOTSUPP, \
                        "pool snapshots on erasure-coded pools are " \
                        "not supported here", None
                if snap in pool.snaps.values():
                    return -EEXIST, f"snap {snap} already exists", None
                pool.snap_seq += 1
                pool.snaps = dict(pool.snaps)
                pool.snaps[pool.snap_seq] = snap
                outs = f"created pool {cmdmap['pool']} snap {snap}"
            else:
                sid = next((i for i, n in pool.snaps.items()
                            if n == snap), None)
                if sid is None:
                    return -ENOENT, f"snap {snap} does not exist", None
                pool.snaps = {i: n for i, n in pool.snaps.items()
                              if i != sid}
                pool.removed_snaps = sorted(
                    set(pool.removed_snaps) | {sid})
                outs = f"removed pool {cmdmap['pool']} snap {snap}"
            self.pending_inc.new_pools[pid] = pool
            return 0, outs, None
        if prefix == "osd pool set":
            pid = self._pool_by_name(cmdmap.get("pool", ""))
            if pid is None:
                return -ENOENT, "pool does not exist", None
            pool = self.pending_inc.new_pools.get(pid) or \
                copy.deepcopy(m.pools[pid])
            var, val = cmdmap.get("var", ""), cmdmap.get("val", "")
            if var == "size":
                if pool.is_erasure():
                    return -EPERM, \
                        "can not change the size of an erasure-coded " \
                        "pool", None
                pool.size = int(val)
                pool.min_size = max(1, int(val) - int(val) // 2)
            elif var == "min_size":
                pool.min_size = int(val)
            elif var in ("pg_num", "pgp_num"):
                n = int(val)
                if var == "pg_num" and n < pool.pg_num:
                    return -EPERM, "pg_num reduction not supported", None
                if var == "pgp_num":
                    if n > pool.pg_num:
                        return -EINVAL, \
                            "pgp_num must not exceed pg_num", None
                    if n < pool.pgp_num:
                        return -EPERM, \
                            "pgp_num reduction not supported", None
                    # growth reseeds split PGs' placement; the peering
                    # statecharts' prior-interval queries + backfill
                    # chase the relocated data — replicated via
                    # osd/peering.py, EC via osd/ec_peering.py's
                    # cross-set chunk sources + pg_temp override
                setattr(pool, var, n)
                if var == "pg_num":
                    pool.pgp_num = min(pool.pgp_num, n)
            elif var == "crush_rule":
                rid = self.wrapper.get_rule_id(str(val))
                if rid < 0:
                    return -ENOENT, f"crush rule {val} does not exist", \
                        None
                pool.crush_rule = m.crush.rules[rid].mask.ruleset
            else:
                return -EINVAL, f"unrecognized variable '{var}'", None
            pool.calc_pg_masks()
            self.pending_inc.new_pools[pid] = pool
            return 0, f"set pool {pid} {var} to {val}", None
        if prefix == "osd erasure-code-profile set":
            name = cmdmap["name"]
            profile = dict(cmdmap.get("profile", {}))
            existing = self._get_profile(name)
            if existing is not None and existing != profile and \
                    not cmdmap.get("force"):
                return -EPERM, \
                    (f"will not override erasure code profile {name} "
                     "because the existing profile is different; pass "
                     "force=true to override"), None
            profile.setdefault("plugin", DEFAULT_EC_PROFILE["plugin"])
            # validate by instantiating
            try:
                ec_registry.factory(profile["plugin"], profile,
                                    device=self.device)
            except Exception as ex:
                return -EINVAL, f"invalid profile: {ex}", None
            self.pending_inc.new_erasure_code_profiles[name] = profile
            return 0, "", None
        if prefix == "osd erasure-code-profile rm":
            name = cmdmap["name"]
            for pid, pool in m.pools.items():
                if pool.erasure_code_profile == name:
                    return -EBUSY, \
                        (f"erasure code profile {name} is in use by "
                         f"pool {m.pool_names[pid]}"), None
            if name in m.erasure_code_profiles:
                self.pending_inc.old_erasure_code_profiles.append(name)
            return 0, "", None
        if prefix in ("osd down", "osd out", "osd in"):
            spec = cmdmap.get("ids", cmdmap.get("id"))
            specs = spec if isinstance(spec, list) else [spec]
            outs = []
            for s in specs:
                osd = self._resolve_osd(s)
                if osd is None:
                    return -EINVAL, f"osd id {s} does not exist", None
                if prefix == "osd down":
                    if m.is_down(osd):
                        outs.append(f"osd.{osd} is already down.")
                    else:
                        self.pending_inc.new_state[osd] = \
                            self.pending_inc.new_state.get(osd, 0) | \
                            CEPH_OSD_UP
                        outs.append(f"marked down osd.{osd}.")
                elif prefix == "osd out":
                    if m.is_out(osd):
                        outs.append(f"osd.{osd} is already out.")
                    else:
                        self.pending_inc.new_weight[osd] = 0
                        outs.append(f"marked out osd.{osd}.")
                else:
                    if m.is_in(osd):
                        outs.append(f"osd.{osd} is already in.")
                    else:
                        self.pending_inc.new_weight[osd] = CEPH_OSD_IN
                        outs.append(f"marked in osd.{osd}.")
            return 0, " ".join(outs), None
        if prefix == "osd reweight":
            osd = self._resolve_osd(cmdmap.get("id"))
            if osd is None:
                return -EINVAL, "osd does not exist", None
            w = float(cmdmap["weight"])
            if not 0.0 <= w <= 1.0:
                return -EINVAL, "weight must be in [0, 1]", None
            self.pending_inc.new_weight[osd] = int(w * CEPH_OSD_IN)
            return 0, f"reweighted osd.{osd} to {w}", None
        if prefix == "osd primary-affinity":
            osd = self._resolve_osd(cmdmap.get("id"))
            if osd is None:
                return -EINVAL, "osd does not exist", None
            w = float(cmdmap["weight"])
            self.pending_inc.new_primary_affinity[osd] = \
                int(w * 0x10000)
            return 0, f"set osd.{osd} primary-affinity to {w}", None
        if prefix == "osd upmap-batch":
            # one proposal for a whole balancer plan (the reference
            # batches via paxos round coalescing; an epoch per item
            # would flood every subscriber with incrementals)
            n = 0
            for pgid in cmdmap.get("rm", []):
                r, outs, _ = self.prepare_command(
                    {"prefix": "osd rm-pg-upmap-items", "pgid": pgid})
                if r != 0:
                    return r, f"rm {pgid}: {outs}", None
                n += 1
            for pgid, pairs in cmdmap.get("set", []):
                r, outs, _ = self.prepare_command(
                    {"prefix": "osd pg-upmap-items", "pgid": pgid,
                     "id_pairs": pairs})
                if r != 0:
                    return r, f"set {pgid}: {outs}", None
                n += 1
            return 0, f"staged {n} upmap changes", None
        if prefix in ("osd pg-upmap-items", "osd rm-pg-upmap-items"):
            pgid = str(cmdmap["pgid"])
            pool_s, _, ps_s = pgid.partition(".")
            pg = PG(int(pool_s), int(ps_s, 16))
            if pg.pool not in m.pools or \
                    pg.ps >= m.pools[pg.pool].pg_num:
                return -ENOENT, f"pg {pgid} does not exist", None
            if prefix == "osd rm-pg-upmap-items":
                self.pending_inc.old_pg_upmap_items.append(pg)
                return 0, f"no change (removed upmap for {pgid})", None
            pairs = cmdmap.get("id_pairs", [])
            items = [(int(a), int(b)) for a, b in pairs]
            for frm, to in items:
                if not (0 <= to < m.max_osd):
                    return -ENOENT, f"osd.{to} does not exist", None
            self.pending_inc.new_pg_upmap_items[pg] = items
            return 0, f"set {pgid} pg_upmap_items mapping to {items}", \
                None
        return -ENOENT, f"unknown command {prefix!r}", None

    # ------------------------------------------------------------- dumps
    def _dump(self) -> dict:
        m = self.osdmap
        return {
            "epoch": m.epoch,
            "max_osd": m.max_osd,
            "pools": [{
                "pool": pid, "pool_name": m.pool_names.get(pid, ""),
                "type": p.type, "size": p.size, "min_size": p.min_size,
                "pg_num": p.pg_num, "crush_rule": p.crush_rule,
                "erasure_code_profile": p.erasure_code_profile,
            } for pid, p in sorted(m.pools.items())],
            "osds": [{
                "osd": o, "up": int(m.is_up(o)), "in": int(m.is_in(o)),
                "weight": m.osd_weight[o] / CEPH_OSD_IN,
            } for o in range(m.max_osd) if m.exists(o)],
            "pg_upmap_items": [
                {"pgid": str(pg), "mappings": items}
                for pg, items in sorted(m.pg_upmap_items.items())],
            "erasure_code_profiles": dict(m.erasure_code_profiles),
        }

    def _tree_text(self) -> str:
        w = self.wrapper
        lines = ["ID  WEIGHT    TYPE NAME"]

        def walk(item: int, depth: int) -> None:
            b = w.crush.bucket(item)
            if b is None:
                name = w.get_item_name(item) or f"osd.{item}"
                lines.append(f"{item:3d} {'':{depth * 2}}{name}")
                return
            tname = w.type_map.get(b.type, str(b.type))
            name = w.get_item_name(item) or ""
            lines.append(
                f"{item:3d} {b.weight / 0x10000:8.4f}  "
                f"{'':{depth * 2}}{tname} {name}")
            for child in b.items:
                walk(child, depth + 1)

        children = {c for b in w.crush.buckets if b is not None
                    for c in b.items}
        roots = [b.id for b in w.crush.buckets
                 if b is not None and b.id not in children]
        for r in sorted(roots, reverse=True):
            walk(r, 0)
        return "\n".join(lines)
