"""cephck rule engine for the port: file walking, waivers, the
suppression baseline, reporting.

Rules are small classes (see rules.py) with an ``id``, a ``doc`` that
says how to read a finding, and ``check(ctx)`` yielding Findings over
one parsed file.  The engine runs in two phases: every file is parsed
first and folded into a ProjectContext (symbol table and call graph,
see project.py), then the rules run per file with ``ctx.project``
carrying the cross-module view.  A finding is then waived inline,
matched against the suppression baseline, or reported.

The port's copy of `ceph_tpu.analysis.engine`.  Two things differ:

* the inline waiver needs a reason here (ref: engine.py:115-118 takes
  the bare marker): ``# cephck: ignore[<rule>] <reason>`` on the
  finding's line or the line above it.  A waiver without its reason
  waives nothing;
* the baseline is the port's own file, ``.cephck-torch-baseline.json``
  at the repository root; the reference's ``.cephck-baseline.json`` is
  never read or written.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import pathlib
import re
import sys
from typing import Iterable, Iterator

from .project import ProjectContext, dotted  # noqa: F401  (dotted is
# re-exported: rules and external callers import it from here)

#: directories never scanned: caches, VCS internals, build output and
#: the fixture corpus
SKIP_PARTS = {"__pycache__", ".git", "fixtures", ".eggs", "build",
              "_build"}

BASELINE_NAME = ".cephck-torch-baseline.json"

_WAIVER = re.compile(r"cephck: ignore\[([\w-]+)\](.*)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""
    rule: str
    path: str          # repo-root-relative posix path
    line: int
    symbol: str        # enclosing def/class qualname
    message: str

    def render(self) -> str:
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{self.path}:{self.line}: {self.rule}{sym}: {self.message}"


class FileContext:
    """One parsed source file and the project it belongs to."""

    def __init__(self, path: pathlib.Path, rel: str, source: str,
                 tree: ast.Module, options: dict | None = None,
                 project: ProjectContext | None = None):
        self.path = path
        self.rel = rel
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        #: engine-wide options (the wire schema lockfile's path)
        self.options = options or {}
        #: the cross-module pass (set by the engine before rules run)
        self.project = project
        self._parents: dict[ast.AST, ast.AST] | None = None

    def module(self):
        """This file's ModuleInfo in the project pass."""
        return self.project.module_for(self.rel) if self.project else None

    def parents(self) -> dict[ast.AST, ast.AST]:
        if self._parents is None:
            self._parents = {}
            for node in ast.walk(self.tree):
                for child in ast.iter_child_nodes(node):
                    self._parents[child] = node
        return self._parents

    def qualname(self, node: ast.AST) -> str:
        """Enclosing class/function qualname of a node."""
        parts: list[str] = []
        parents = self.parents()
        cur = parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                parts.append(cur.name)
            cur = parents.get(cur)
        return ".".join(reversed(parts)) or "<module>"

    def imports_torch(self) -> bool:
        mod = self.module()
        return mod is not None and mod.imports_module("torch")

    def finding(self, rule: str, node: ast.AST, message: str,
                symbol: str | None = None) -> Finding:
        return Finding(rule=rule, path=self.rel,
                       line=getattr(node, "lineno", 0),
                       symbol=symbol if symbol is not None
                       else self.qualname(node),
                       message=message)

    def waivers(self) -> Iterator[tuple[int, str, str]]:
        """(line, rule, reason) of every inline waiver in the file."""
        for i, text in enumerate(self.lines, 1):
            m = _WAIVER.search(text)
            if m:
                yield i, m.group(1), m.group(2).strip()

    def inline_waived(self, f: Finding) -> bool:
        """A ``# cephck: ignore[<rule>] <reason>`` on the finding's line or
        the line directly above waives it; one without a reason does
        not."""
        for ln in (f.line - 1, f.line - 2):
            if 0 <= ln < len(self.lines):
                m = _WAIVER.search(self.lines[ln])
                if m and m.group(1) == f.rule and m.group(2).strip():
                    return True
        return False


def repo_root(start: pathlib.Path | None = None) -> pathlib.Path:
    """Nearest ancestor carrying pyproject.toml (falls back to cwd)."""
    cur = (start or pathlib.Path.cwd()).resolve()
    if cur.is_file():
        cur = cur.parent
    for cand in (cur, *cur.parents):
        if (cand / "pyproject.toml").exists():
            return cand
    return pathlib.Path.cwd()


def collect_files(paths: Iterable[str],
                  root: pathlib.Path) -> list[pathlib.Path]:
    out: list[pathlib.Path] = []
    for p in paths:
        pp = pathlib.Path(p)
        if not pp.is_absolute():
            pp = root / pp
        if pp.is_file() and pp.suffix == ".py":
            out.append(pp)
        elif pp.is_dir():
            for f in sorted(pp.rglob("*.py")):
                if not SKIP_PARTS.intersection(f.parts):
                    out.append(f)
        elif not pp.exists():
            raise FileNotFoundError(f"cephck: no such path: {p}")
    return out




# ------------------------------------------------------------ baseline

class BaselineError(ValueError):
    """Malformed baseline — including any entry without a reason."""


@dataclasses.dataclass
class Suppression:
    rule: str
    path: str
    symbol: str        # "" matches any symbol
    reason: str
    used: int = 0

    def matches(self, f: Finding) -> bool:
        # exact repo-relative path only: a suffix match would let one
        # entry swallow findings from a later file of the same name
        if self.rule != f.rule or f.path != self.path:
            return False
        return self.symbol in ("", f.symbol)


def load_baseline(path: pathlib.Path) -> list[Suppression]:
    """Load and validate the baseline: every entry must name a rule, a
    path, and a one-line human reason.  An unexplained suppression is
    rejected outright — the baseline is the audit trail for every
    finding the tree is allowed to keep."""
    try:
        data = json.loads(path.read_text())
    except json.JSONDecodeError as ex:
        raise BaselineError(f"{path}: invalid JSON: {ex}") from ex
    entries = data.get("suppressions")
    if not isinstance(entries, list):
        raise BaselineError(f"{path}: expected a 'suppressions' list")
    out = []
    for i, e in enumerate(entries):
        reason = str(e.get("reason", "")).strip()
        rule = str(e.get("rule", "")).strip()
        rel = str(e.get("path", "")).strip()
        if not rule or not rel:
            raise BaselineError(
                f"{path}: suppression #{i} needs 'rule' and 'path'")
        if not reason or "\n" in reason:
            raise BaselineError(
                f"{path}: suppression #{i} ({rule} @ {rel}) needs a "
                "one-line 'reason' — unexplained baseline entries are "
                "not allowed")
        out.append(Suppression(rule=rule, path=rel,
                               symbol=str(e.get("symbol", "")).strip(),
                               reason=reason))
    return out


def prune_baseline(path: pathlib.Path,
                   stale: list[Suppression]) -> int:
    """Rewrite the baseline file dropping `stale` entries (matched by
    rule/path/symbol), keeping everything else verbatim — the
    ``--prune-baseline`` rewrite.  Returns how many entries went."""
    data = json.loads(path.read_text())
    gone = {(s.rule, s.path, s.symbol) for s in stale}
    kept = [e for e in data.get("suppressions", [])
            if (str(e.get("rule", "")).strip(),
                str(e.get("path", "")).strip(),
                str(e.get("symbol", "")).strip()) not in gone]
    dropped = len(data.get("suppressions", [])) - len(kept)
    data["suppressions"] = kept
    path.write_text(json.dumps(data, indent=1) + "\n")
    return dropped


# -------------------------------------------------------------- engine

class Engine:
    def __init__(self, rules, root: pathlib.Path,
                 wire_schema: pathlib.Path | None = None,
                 suppressions: list[Suppression] | None = None):
        self.rules = list(rules)
        self.root = root
        self.options = {
            "wire_schema": wire_schema or
            root / "tests" / "fixtures" / "wire_schema.json",
        }
        self.suppressions = suppressions or []
        self.findings: list[Finding] = []
        #: findings an inline waiver with its reason took out
        self.waived: list[Finding] = []
        self.suppressed: list[tuple[Finding, Suppression]] = []
        self.errors: list[str] = []
        self.scanned: list[str] = []

    def _parse(self, path: pathlib.Path) -> FileContext | None:
        try:
            source = path.read_text()
            tree = ast.parse(source, filename=str(path))
        except (OSError, SyntaxError) as ex:
            self.errors.append(f"{path}: {ex}")
            return None
        try:
            rel = path.resolve().relative_to(self.root.resolve()).as_posix()
        except ValueError:
            rel = path.as_posix()
        self.scanned.append(rel)
        return FileContext(path, rel, source, tree, self.options)

    def _check_ctx(self, ctx: FileContext) -> Iterator[Finding]:
        for rule in self.rules:
            for f in rule.check(ctx):
                if ctx.inline_waived(f):
                    self.waived.append(f)
                    continue
                for s in self.suppressions:
                    if s.matches(f):
                        s.used += 1
                        self.suppressed.append((f, s))
                        break
                else:
                    self.findings.append(f)
                    yield f

    def check_file(self, path: pathlib.Path) -> Iterator[Finding]:
        """Single-file scan (fixture tests): the project pass degrades
        to a one-module table, so cross-module rules still run."""
        ctx = self._parse(path)
        if ctx is None:
            return
        project = ProjectContext()
        project.add(ctx.rel, ctx.tree)
        project.finalize()
        ctx.project = project
        yield from self._check_ctx(ctx)

    def run(self, paths: Iterable[str]) -> int:
        """Scan `paths`; 1 when any finding is left unwaived and
        unsuppressed (or a file does not parse), else 0."""
        ctxs: list[FileContext] = []
        project = ProjectContext()
        for f in collect_files(paths, self.root):
            ctx = self._parse(f)
            if ctx is not None:
                project.add(ctx.rel, ctx.tree)
                ctxs.append(ctx)
        project.finalize()
        for ctx in ctxs:
            ctx.project = project
            for _ in self._check_ctx(ctx):
                pass
        return 1 if (self.findings or self.errors) else 0

    def stale_suppressions(self) -> list[Suppression]:
        """Unused entries whose path was actually scanned — a partial
        scan (one file) must not cry stale about the rest of the
        baseline."""
        return [s for s in self.suppressions
                if not s.used and s.path in self.scanned]


# ----------------------------------------------------------------- CLI

def sarif_report(rules, findings, errors=(), stale=()) -> dict:
    """SARIF 2.1.0 log for code-scanning uploads (the github format
    annotates the diff; SARIF fills the code-scanning tab and survives
    as an artifact).  String escaping is json.dumps's job — messages
    with quotes, newlines or %-sequences must round-trip verbatim."""
    fired = {f.rule for f in findings}
    driver_rules = [{
        "id": r.id,
        "shortDescription": {
            "text": (r.doc or r.id).strip().splitlines()[0]},
        "fullDescription": {"text": (r.doc or r.id).strip()},
    } for r in rules if r.id in fired]
    index = {dr["id"]: i for i, dr in enumerate(driver_rules)}
    results = [{
        "ruleId": f.rule,
        "ruleIndex": index[f.rule],
        "level": "error",
        "message": {"text": f.message},
        "locations": [{
            "physicalLocation": {
                "artifactLocation": {"uri": f.path,
                                     "uriBaseId": "SRCROOT"},
                "region": {"startLine": f.line},
            },
        }],
    } for f in findings]
    notifications = [
        {"level": "error", "message": {"text": e}} for e in errors
    ] + [
        {"level": "error",
         "message": {"text": f"stale suppression ({s.rule} @ {s.path})"
                             f" no longer matches any finding"}}
        for s in stale
    ]
    return {
        "$schema": "https://json.schemastore.org/sarif-2.1.0.json",
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "cephck",
                "rules": driver_rules,
            }},
            "originalUriBaseIds": {"SRCROOT": {"uri": "file:///"}},
            "invocations": [{
                "executionSuccessful": not (errors or stale),
                "toolExecutionNotifications": notifications,
            }],
            "results": results,
        }],
    }


def _github_escape(s: str) -> str:
    """The workflow-command grammar's escaping of a message."""
    return s.replace("%", "%25").replace("\r", "%0D").replace("\n", "%0A")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ceph_tpu_torch.analysis",
        description="cephck for the port "
                    "(exit 0 = clean, 1 = findings, 2 = bad config)")
    ap.add_argument("paths", nargs="*",
                    default=["ceph_tpu_torch", "chip_smoke.py"],
                    help="files or directories to scan")
    ap.add_argument("--baseline", default=None,
                    help=f"suppression baseline (default: "
                         f"<repo-root>/{BASELINE_NAME})")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline: report everything")
    ap.add_argument("--prune-baseline", action="store_true",
                    help="rewrite the baseline dropping stale entries "
                         "(entries that no longer match a finding); "
                         "without this flag stale entries fail the run")
    ap.add_argument("--wire-schema", default=None,
                    help="wire schema lockfile (default: "
                         "tests/fixtures/wire_schema.json)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable findings on stdout "
                         "(alias for --format json)")
    ap.add_argument("--format", default=None, dest="fmt",
                    choices=("text", "json", "github", "sarif"),
                    help="findings output: text (default), json (one "
                         "document), github (::error workflow "
                         "annotations) or sarif (a 2.1.0 log)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print every rule id and its one-line summary")
    ap.add_argument("--explain", metavar="RULE",
                    help="print a rule's full doc (how to read and fix "
                         "its findings)")
    args = ap.parse_args(argv)

    from .rules import ALL_RULES
    rules = [cls() for cls in ALL_RULES]
    if args.list_rules:
        for r in rules:
            print(f"{r.id:22s} {r.doc.strip().splitlines()[0]}")
        return 0
    if args.explain:
        for r in rules:
            if r.id == args.explain:
                print(f"{r.id}\n{'=' * len(r.id)}\n{r.doc.strip()}")
                return 0
        print(f"cephck: unknown rule {args.explain!r}", file=sys.stderr)
        return 2

    root = repo_root()
    suppressions: list[Suppression] = []
    bpath = None
    if not args.no_baseline:
        bpath = pathlib.Path(args.baseline) if args.baseline \
            else root / BASELINE_NAME
        if bpath.exists():
            try:
                suppressions = load_baseline(bpath)
            except BaselineError as ex:
                print(f"cephck: {ex}", file=sys.stderr)
                return 2
        elif args.baseline:
            print(f"cephck: baseline not found: {bpath}", file=sys.stderr)
            return 2

    wire = pathlib.Path(args.wire_schema) if args.wire_schema else None
    eng = Engine(rules, root, wire_schema=wire, suppressions=suppressions)
    try:
        rc = eng.run(args.paths)
    except FileNotFoundError as ex:
        print(ex, file=sys.stderr)
        return 2

    stale = eng.stale_suppressions()
    if stale and args.prune_baseline and bpath and bpath.exists():
        prune_baseline(bpath, stale)
        for s in stale:
            print(f"cephck: pruned stale suppression "
                  f"({s.rule} @ {s.path})", file=sys.stderr)
        stale = []

    fmt = args.fmt or ("json" if args.as_json else "text")
    if fmt == "json":
        print(json.dumps({
            "findings": [dataclasses.asdict(f) for f in eng.findings],
            "suppressed": len(eng.suppressed),
            "stale": [dataclasses.asdict(s) for s in stale],
            "errors": eng.errors,
        }, indent=1))
    elif fmt == "sarif":
        print(json.dumps(sarif_report(rules, eng.findings,
                                      eng.errors, stale), indent=1))
    elif fmt == "github":
        for f in eng.findings:
            print(f"::error file={f.path},line={f.line},"
                  f"title=cephck {f.rule}::{_github_escape(f.message)}")
        for e in eng.errors:
            print(f"::error title=cephck parse error::{_github_escape(e)}")
        for s in stale:
            print(f"::error file={s.path},title=cephck stale "
                  f"suppression::{_github_escape(s.rule)} no longer "
                  f"matches any finding — remove it or run "
                  f"--prune-baseline")
        print(f"cephck: {len(eng.findings)} finding(s), "
              f"{len(eng.suppressed)} suppressed by baseline",
              file=sys.stderr)
    else:
        for f in eng.findings:
            print(f.render())
        for e in eng.errors:
            print(f"cephck: parse error: {e}", file=sys.stderr)
        for s in stale:
            print(f"cephck: stale suppression ({s.rule} @ {s.path}) "
                  f"no longer matches any finding — remove it or run "
                  f"--prune-baseline", file=sys.stderr)
        print(f"cephck: {len(eng.findings)} finding(s), "
              f"{len(eng.waived)} waived inline, "
              f"{len(eng.suppressed)} suppressed by baseline"
              + (f", {len(eng.errors)} parse error(s)"
                 if eng.errors else "")
              + (f", {len(stale)} STALE suppression(s)"
                 if stale else ""))
    if stale and rc == 0:
        # a suppression nothing matches is a blindfold over code that
        # moved: the gate fails until the baseline shrinks to fit
        rc = 1
    return rc
