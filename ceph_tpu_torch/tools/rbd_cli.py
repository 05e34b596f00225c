"""rbd CLI: image management verbs over a running cluster.

The `rbd` tool surface (ref: src/tools/rbd/, action/*.cc verbs),
connected like the rados CLI via --monmap (TCP daemon world of
tools/daemon_main + vstart):

    rbd --monmap mm.json create -p rbd --size 16M img
    rbd --monmap mm.json ls -p rbd
    rbd --monmap mm.json info -p rbd img
    rbd --monmap mm.json snap create -p rbd img@s1
    rbd --monmap mm.json clone -p rbd img@s1 child
    rbd --monmap mm.json du -p rbd img
    rbd --monmap mm.json flatten -p rbd child

`main(argv, rados=...)` accepts a pre-connected client so the test
tier drives the verbs in-process (the cram-style CLI tier model,
ref: src/test/cli/rbd/).

The port's copy of `ceph_tpu.tools.rbd_cli`: every verb, with the
reference's stdout and stderr text and return codes.  It connects as
the port's `rados` CLI does (`--monmap`, `--keyring`, `--timeout`;
with a keyring that holds `client.admin` it authenticates as
`client.admin`).
"""
from __future__ import annotations

import argparse
import sys

from ..rbd import RBD, Image, RBDError


def _parse_size(s: str) -> int:
    s = s.strip().upper()
    mult = 1
    for suf, m in (("K", 1 << 10), ("M", 1 << 20), ("G", 1 << 30),
                   ("T", 1 << 40)):
        if s.endswith(suf):
            s, mult = s[:-1], m
            break
    return int(float(s) * mult)


def _fmt_size(n: int) -> str:
    for suf, m in (("TiB", 1 << 40), ("GiB", 1 << 30),
                   ("MiB", 1 << 20), ("KiB", 1 << 10)):
        if n >= m:
            return f"{n / m:.4g} {suf}"
    return f"{n} B"


def _split_spec(spec: str) -> tuple[str, str | None]:
    """"image[@snap]" -> (image, snap|None)."""
    if "@" in spec:
        img, snap = spec.split("@", 1)
        return img, snap
    return spec, None


def _connect(args):
    from .rados_cli import _connect as rados_connect
    return rados_connect(args)


# ------------------------------------------------------------ commands

def cmd_create(io, a, out):
    RBD().create(io, a.image, _parse_size(a.size), order=a.order)
    print(f"created image {a.image}", file=out)


def cmd_ls(io, a, out):
    for name in RBD().list(io):
        print(name, file=out)


def cmd_info(io, a, out):
    name, snap = _split_spec(a.image)
    img = Image(io, name, snapshot=snap)
    st = img.stat()
    print(f"rbd image '{name}':", file=out)
    print(f"\tsize {_fmt_size(st['size'])} in {st['num_objs']} "
          f"objects", file=out)
    print(f"\torder {st['order']} ({_fmt_size(st['obj_size'])} "
          f"objects)", file=out)
    if img.parent is not None:
        p = img.parent
        print(f"\tparent: {p['pool']}/{p['image']}@{p['snap_name']} "
              f"(overlap {_fmt_size(p['overlap'])})", file=out)
    img.close()


def cmd_rm(io, a, out):
    RBD().remove(io, a.image)
    print(f"removed image {a.image}", file=out)


def cmd_resize(io, a, out):
    img = Image(io, a.image)
    img.resize(_parse_size(a.size))
    img.close()
    print(f"resized image {a.image}", file=out)


def cmd_du(io, a, out):
    img = Image(io, a.image)
    used = img.du()
    st = img.stat()
    print(f"{a.image} provisioned {_fmt_size(st['size'])} used "
          f"{_fmt_size(used)}", file=out)
    img.close()


def cmd_diff(io, a, out):
    name, snap = _split_spec(a.image)
    img = Image(io, name)
    for d in img.diff_since(a.from_snap):
        kind = "data" if d["exists"] else "zero"
        print(f"{d['offset']}\t{d['length']}\t{kind}", file=out)
    img.close()


def cmd_snap(io, a, out):
    name, snap = _split_spec(a.image)
    img = Image(io, name)
    try:
        if a.snap_cmd == "create":
            img.snap_create(snap)
            print(f"created snapshot {name}@{snap}", file=out)
        elif a.snap_cmd == "ls":
            for s in img.snap_list():
                prot = " (protected)" if \
                    img.snap_is_protected(s["name"]) else ""
                print(f"{s['id']}\t{s['name']}\t"
                      f"{_fmt_size(s['size'])}{prot}", file=out)
        elif a.snap_cmd == "rm":
            img.snap_remove(snap)
            print(f"removed snapshot {name}@{snap}", file=out)
        elif a.snap_cmd == "rollback":
            img.snap_rollback(snap)
            print(f"rolled back to {name}@{snap}", file=out)
        elif a.snap_cmd == "protect":
            img.snap_protect(snap)
            print(f"protected {name}@{snap}", file=out)
        elif a.snap_cmd == "unprotect":
            img.snap_unprotect(snap)
            print(f"unprotected {name}@{snap}", file=out)
    finally:
        img.close()


def cmd_clone(io, a, out):
    p_name, p_snap = _split_spec(a.parent_spec)
    if p_snap is None:
        raise RBDError(22, "clone needs parent@snap")
    RBD().clone(io, p_name, p_snap, io, a.child)
    print(f"cloned {p_name}@{p_snap} -> {a.child}", file=out)


def cmd_flatten(io, a, out):
    img = Image(io, a.image)
    img.flatten()
    img.close()
    print(f"flattened image {a.image}", file=out)


def cmd_children(io, a, out):
    name, snap = _split_spec(a.image)
    img = Image(io, name)
    for pool, child in img.children():
        print(f"{pool}/{child}", file=out)
    img.close()


# ---------------------------------------------------------------- main

def main(argv=None, rados=None, out=None) -> int:
    out = out or sys.stdout
    ap = argparse.ArgumentParser(prog="rbd")
    ap.add_argument("--monmap", help="cluster monmap json")
    ap.add_argument("--keyring", default="",
                    help="keyring JSON (secure-mode clusters)")
    ap.add_argument("-p", "--pool", default="rbd")
    ap.add_argument("--timeout", type=float, default=30.0)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("create")
    p.add_argument("image")
    p.add_argument("--size", required=True)
    p.add_argument("--order", type=int, default=22)
    sub.add_parser("ls")
    for verb in ("info", "rm", "du", "flatten", "children"):
        p = sub.add_parser(verb)
        p.add_argument("image")
    p = sub.add_parser("resize")
    p.add_argument("image")
    p.add_argument("--size", required=True)
    p = sub.add_parser("diff")
    p.add_argument("image")
    p.add_argument("--from-snap", default=None)
    p = sub.add_parser("snap")
    p.add_argument("snap_cmd", choices=["create", "ls", "rm",
                                        "rollback", "protect",
                                        "unprotect"])
    p.add_argument("image")
    p = sub.add_parser("clone")
    p.add_argument("parent_spec")
    p.add_argument("child")
    a = ap.parse_args(argv)

    own = rados is None
    r = rados if rados is not None else _connect(a)
    try:
        io = r.open_ioctx(a.pool)
        handler = globals()[f"cmd_{a.cmd}"]
        handler(io, a, out)
        return 0
    except (RBDError, OSError) as ex:
        print(f"rbd: {ex}", file=sys.stderr)
        return 1
    finally:
        if own:
            r.shutdown()


if __name__ == "__main__":
    raise SystemExit(main())
