"""cephck rule engine for the port: file walking, waivers, reporting.

Rules are small classes (see rules.py) with an ``id``, a ``doc`` that
says how to read a finding, and ``check(ctx)`` yielding Findings over
one parsed file.  The engine runs in two phases: every file is parsed
first and folded into a ProjectContext (symbol table and call graph,
see project.py), then the rules run per file with ``ctx.project``
carrying the cross-module view.

The port's copy of `ceph_tpu.analysis.engine` in part: `Finding`,
`FileContext`, the two-phase `Engine`, file collection and the text
report.  The inline waiver (ref: engine.py:115-118) needs a reason
here: ``# cephck: ignore[<rule>] <reason>`` on the finding's line or
the line above it.  A waiver without its reason waives nothing.  Left
out: the suppression baseline and the json, github and sarif formats.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import pathlib
import re
import sys
from typing import Iterable, Iterator

from .project import ProjectContext

#: directories never scanned: caches, VCS internals, build output and
#: the fixture corpus
SKIP_PARTS = {"__pycache__", ".git", "fixtures", ".eggs", "build",
              "_build"}

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
                 tree: ast.Module, project: ProjectContext | None = None):
        self.path = path
        self.rel = rel
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
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


class Engine:
    def __init__(self, rules, root: pathlib.Path):
        self.rules = list(rules)
        self.root = root
        self.findings: list[Finding] = []
        #: findings an inline waiver with its reason took out
        self.waived: list[Finding] = []
        self.errors: list[str] = []

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
        return FileContext(path, rel, source, tree)

    def _check_ctx(self, ctx: FileContext) -> None:
        for rule in self.rules:
            for f in rule.check(ctx):
                (self.waived if ctx.inline_waived(f)
                 else self.findings).append(f)

    def run(self, paths: Iterable[str]) -> int:
        """Scan `paths`; 1 when any finding is left unwaived (or a file
        does not parse), else 0."""
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
            self._check_ctx(ctx)
        return 1 if (self.findings or self.errors) else 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ceph_tpu_torch.analysis",
        description="cephck device-contract rules for the port "
                    "(exit 0 = clean, 1 = findings, 2 = bad path)")
    ap.add_argument("paths", nargs="*",
                    default=["ceph_tpu_torch", "chip_smoke.py"],
                    help="files or directories to scan")
    ap.add_argument("--list-rules", action="store_true",
                    help="print every rule id and its one-line summary")
    args = ap.parse_args(argv)

    from .rules import ALL_RULES
    rules = [cls() for cls in ALL_RULES]
    if args.list_rules:
        for r in rules:
            print(f"{r.id:22s} {r.doc.strip().splitlines()[0]}")
        return 0
    eng = Engine(rules, repo_root())
    try:
        rc = eng.run(args.paths)
    except FileNotFoundError as ex:
        print(ex, file=sys.stderr)
        return 2
    for f in eng.findings:
        print(f.render())
    for e in eng.errors:
        print(f"cephck: parse error: {e}", file=sys.stderr)
    print(f"cephck: {len(eng.findings)} finding(s), {len(eng.waived)} "
          f"waived inline"
          + (f", {len(eng.errors)} parse error(s)" if eng.errors else ""))
    return rc
