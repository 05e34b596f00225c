"""cephfs-lite: a POSIX-ish file namespace on RADOS.

Multi-rank metadata servers + libcephfs-like client
(ref: src/mds + src/client: dentry-omap directory objects in a
metadata pool, a per-rank write-ahead journal over the port's journal/,
striped file data objects `{ino}.{objno}` in a data pool, caps,
subtree pinning/balancing, snapshots — and standby/failover: the mon's
MDSMonitor promotes MDSStandby daemons through replay -> resolve ->
active when a rank's beacon lapses).

The port's copy of `ceph_tpu.fs`.  Every file's data goes through the
OSDs' own paths, so on an erasure-coded data pool each write encodes
and each degraded read decodes on the EC kernels; nothing here runs a
kernel itself.  Two rules differ from the reference: a `mksnap` whose
data pool refuses self-managed snaps (an erasure-coded pool) is
answered EOPNOTSUPP where the reference's MDS raises on its dispatch
thread and leaves the client to time out, and a swallowed `RadosError`
whose errno is not ENOENT or EEXIST is counted in `SWALLOWED`, by site.
The MDS also counts the errors a daemon process's tick loop survived
(`perf`, `tick_errors`), which its admin socket serves as `perf dump`.
"""
from .client import CephFS, FileHandle
from .mds import SWALLOWED, MDSDaemon, MDSStandby

__all__ = ["MDSDaemon", "MDSStandby", "CephFS", "FileHandle", "SWALLOWED"]
