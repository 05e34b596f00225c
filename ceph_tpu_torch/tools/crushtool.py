"""crushtool equivalent: compile/decompile text crushmaps, test maps.

CLI port of src/tools/crushtool.cc:
  crushtool -c map.txt -o map.json        # compile text -> map
  crushtool -d map.json [-o map.txt]      # decompile map -> text
  crushtool -i map.json --test [--min-x N --max-x N --num-rep N
      --rule N --show-utilization --show-statistics --show-mappings
      --show-bad-mappings]
  crushtool -i map.json --tree
  crushtool --build --num-osds N -o map.json LAYER ALG SIZE ...

The compiled map is stored as JSON (this framework's codec; the
reference uses its binary encoding).  --test maps every x of a
(rule, num_rep) through the batch CRUSH engine in one call
(ceph_tpu_torch.crush.tester): K3 on the card by default, its plain
version with `--device cpu`.

The port's copy of `ceph_tpu.tools.crushtool`; map files and output are
interchangeable with the reference tool's.

    python -m ceph_tpu_torch.tools.crushtool -i map.json --test \
        --show-statistics --rule 0 --num-rep 3 [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import sys

from ..crush.codec import wrapper_from_json, wrapper_to_json
from ..crush.compiler import ALG_IDS, CompileError, compile_crushmap, decompile
from ..crush.tester import CrushTester
from ..crush.wrapper import CrushWrapper


def save(w: CrushWrapper, path: str) -> None:
    with open(path, "w") as f:
        json.dump(wrapper_to_json(w), f)


def load(path: str) -> CrushWrapper:
    with open(path) as f:
        return wrapper_from_json(json.load(f))


# ------------------------------------------------------------------- tree
def tree_text(w: CrushWrapper) -> str:
    lines = ["ID\tWEIGHT\tTYPE NAME"]

    def walk(item: int, depth: int) -> None:
        b = w.crush.bucket(item)
        indent = "\t" * 0 + " " * (depth * 4)
        if b is None:
            name = w.name_map.get(item, f"osd.{item}")
            lines.append(f"{item}\t\t{indent}{name}")
            return
        tname = w.type_map.get(b.type, str(b.type))
        name = w.name_map.get(item, "")
        lines.append(f"{item}\t{b.weight / 0x10000:g}\t{indent}"
                     f"{tname} {name}")
        for child in b.items:
            walk(child, depth + 1)

    children = {c for b in w.crush.buckets if b is not None
                for c in b.items}
    roots = [b.id for b in w.crush.buckets
             if b is not None and b.id not in children]
    for r in sorted(roots, reverse=True):
        walk(r, 0)
    return "\n".join(lines) + "\n"


def build_map(num_osds: int, layers: list[tuple[str, str, int]]
              ) -> CrushWrapper:
    """--build: bottom-up tree, SIZE children per bucket (0 = all)
    (ref: crushtool.cc --build / CrushWrapper::build_hierarchy)."""
    w = CrushWrapper()
    w.type_map = {0: "osd"}
    for dev in range(num_osds):
        w.name_map[dev] = f"osd.{dev}"
    w.crush.max_devices = num_osds
    prev: list[int] = list(range(num_osds))
    for depth, (tname, alg, size) in enumerate(layers, start=1):
        w.type_map[depth] = tname
        if alg not in ALG_IDS:
            raise CompileError(f"unknown alg {alg!r}")
        cur: list[int] = []
        n = size or len(prev)
        for base in range(0, len(prev), n):
            group = prev[base:base + n]
            name = f"{tname}{len(cur)}" if size else tname
            bid = w.add_bucket(name, tname, alg=ALG_IDS[alg])
            b = w.crush.bucket(bid)
            for it in group:
                cw = 0x10000 if it >= 0 else w.crush.bucket(it).weight
                b.items.append(it)
                b.item_weights.append(cw)
                b.weight += cw
            cur.append(bid)
        prev = cur
    return w


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="crushtool")
    ap.add_argument("-c", "--compile", metavar="SRC", dest="compile_src")
    ap.add_argument("-d", "--decompile", metavar="MAP",
                    dest="decompile_src")
    ap.add_argument("-i", "--infn", metavar="MAP")
    ap.add_argument("-o", "--outfn", metavar="OUT")
    ap.add_argument("--test", action="store_true")
    ap.add_argument("--tree", action="store_true")
    ap.add_argument("--build", action="store_true")
    ap.add_argument("--num-osds", type=int, default=0)
    ap.add_argument("--min-x", type=int, default=0)
    ap.add_argument("--max-x", type=int, default=1023)
    ap.add_argument("--num-rep", type=int, default=0)
    ap.add_argument("--rule", type=int, default=-1)
    ap.add_argument("--show-utilization", action="store_true")
    ap.add_argument("--show-statistics", action="store_true")
    ap.add_argument("--show-mappings", action="store_true")
    ap.add_argument("--show-bad-mappings", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where --test maps: the card (K3) or the CPU "
                         "(its plain version)")
    ap.add_argument("layers", nargs="*",
                    help="--build: TYPE ALG SIZE triples")
    args = ap.parse_args(argv)

    try:
        if args.compile_src:
            with open(args.compile_src) as f:
                w = compile_crushmap(f.read())
            out = args.outfn or args.compile_src + ".compiled"
            save(w, out)
            print(f"crushtool successfully built or modified map.  "
                  f"output to {out}", file=sys.stderr)
            return 0
        if args.decompile_src:
            w = load(args.decompile_src)
            text = decompile(w)
            if args.outfn:
                with open(args.outfn, "w") as f:
                    f.write(text)
            else:
                sys.stdout.write(text)
            return 0
        if args.build:
            if args.num_osds <= 0 or len(args.layers) % 3:
                print("--build requires --num-osds and TYPE ALG SIZE "
                      "triples", file=sys.stderr)
                return 1
            triples = [(args.layers[i], args.layers[i + 1],
                        int(args.layers[i + 2]))
                       for i in range(0, len(args.layers), 3)]
            w = build_map(args.num_osds, triples)
            if args.outfn:
                save(w, args.outfn)
                print(f"crushtool successfully built or modified map.  "
                      f"output to {args.outfn}", file=sys.stderr)
            else:
                sys.stdout.write(decompile(w))
            return 0
        if args.infn:
            w = load(args.infn)
            if args.tree:
                sys.stdout.write(tree_text(w))
            if args.test:
                t = CrushTester(w, min_x=args.min_x, max_x=args.max_x,
                                min_rep=args.num_rep,
                                max_rep=args.num_rep, rule=args.rule,
                                device=args.device)
                sys.stdout.write(t.test(
                    show_utilization=args.show_utilization,
                    show_statistics=args.show_statistics,
                    show_mappings=args.show_mappings,
                    show_bad_mappings=args.show_bad_mappings))
            return 0
    except (CompileError, FileNotFoundError, json.JSONDecodeError,
            KeyError) as ex:
        print(f"crushtool: {ex!r}", file=sys.stderr)
        return 1
    ap.print_usage()
    return 1


if __name__ == "__main__":
    sys.exit(main())
