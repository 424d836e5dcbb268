"""The port's layering lint (port of ``repro/analysis/lint.py``): AST rules
that keep the port's layering doctrine checked by a machine.

Rules (each selectable; ``python -m repro_torch.tools.lint`` is the CLI):

  * ``no-reference-import`` -- no module under ``src/repro_torch/``, and
    not ``chip_smoke.py``, imports ``jax`` (or ``jaxlib``) or the
    reference package ``repro``: the port keeps its own copy of what it
    needs.  It stands where the reference's ``compat-only`` stands (the
    port has no version-specific JAX symbols to fence in).
  * ``quant-blockwise`` -- hot paths go through ``kernels.ops``; direct
    ``quant.blockwise`` imports are allowed only in a package's
    ``kernels/`` and ``quant/`` and in ``tests/`` (parity suites).
  * ``bare-assert`` -- no ``assert`` in non-test source: ``python -O``
    strips them, so validation must raise.
  * ``parity-tags`` -- every public function of ``kernels/ops.py`` and
    every wire primitive of ``core/wire.py`` declares its parity class
    with a ``PARITY: BITWISE|ALLCLOSE`` docstring tag, and a tag anywhere
    names one of the two.  The reference also holds each tag to
    ``DESIGN.md``'s kernel table; that table is the reference's Pallas
    kernels against XLA, while the port's classes are against the
    reference (ROADMAP "Parity classes"), so the port drops that
    cross-check.
  * ``tracked-bytecode`` -- no ``*.pyc`` / ``__pycache__`` tracked by git.

Each finding is a ``LintError`` (path, line, rule, message).  The rules
are a registry of functions (``RULES``, ``REPO_RULES``).
"""
from __future__ import annotations

import ast
import dataclasses
import re
import subprocess
import sys
from pathlib import Path
from typing import Callable, Iterable, Iterator, Optional


@dataclasses.dataclass(frozen=True)
class LintError:
    path: str   # repo-relative
    line: int
    rule: str
    msg: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.msg}"


def _imported_dotted(tree: ast.AST) -> Iterator[tuple[int, str]]:
    """Every imported dotted name with its line: ``import a.b`` -> ``a.b``;
    ``from a.b import c`` -> ``a.b`` and ``a.b.c``; relative levels kept
    as leading dots."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            base = "." * node.level + (node.module or "")
            yield node.lineno, base
            for alias in node.names:
                yield node.lineno, (f"{base}.{alias.name}" if base
                                    else alias.name)


# --------------------------------------------------------------------------- #
# rule: no-reference-import
# --------------------------------------------------------------------------- #
_PORT = ("src/repro_torch/", "chip_smoke.py")
_REFERENCE_ROOTS = ("jax", "jaxlib", "repro")


def check_no_reference_import(rel: str, tree: ast.AST, src: str
                              ) -> list[LintError]:
    """The port imports neither JAX nor the reference package."""
    if not rel.startswith(_PORT):
        return []
    errs = []
    seen: set[int] = set()  # one finding per import line
    for line, name in _imported_dotted(tree):
        if name.startswith(".") or line in seen:
            continue
        if name.split(".")[0] in _REFERENCE_ROOTS:
            seen.add(line)
            errs.append(LintError(
                rel, line, "no-reference-import",
                f"the port imports {name!r}; it imports torch, never JAX "
                f"or the reference package (keep a copy of what it needs)"))
    return errs


# --------------------------------------------------------------------------- #
# rule: quant-blockwise
# --------------------------------------------------------------------------- #
_QUANT_ALLOWED = re.compile(r"^(src/[^/]+/(kernels|quant)/|tests/)")
_QUANT_NAMES = ("quant", "quant.blockwise", "repro.quant",
                "repro.quant.blockwise", "repro_torch.quant",
                "repro_torch.quant.blockwise")
_QUANT_PREFIXES = ("quant.blockwise.", "repro.quant.blockwise.",
                   "repro_torch.quant.blockwise.")


def check_quant_blockwise(rel: str, tree: ast.AST, src: str
                          ) -> list[LintError]:
    """Hot paths import kernels.ops, never quant.blockwise."""
    if _QUANT_ALLOWED.match(rel):
        return []
    errs = []
    seen: set[int] = set()
    for line, name in _imported_dotted(tree):
        bare = name.lstrip(".")
        if bare in _QUANT_NAMES or bare.startswith(_QUANT_PREFIXES):
            if line in seen:
                continue
            seen.add(line)
            errs.append(LintError(
                rel, line, "quant-blockwise",
                f"direct plain-codec import {name!r}; hot paths go through "
                f"kernels.ops (kernels.ref for the plain versions)"))
    return errs


# --------------------------------------------------------------------------- #
# rule: bare-assert
# --------------------------------------------------------------------------- #
def check_bare_assert(rel: str, tree: ast.AST, src: str) -> list[LintError]:
    """No ``assert`` in non-test source: ``python -O`` strips them."""
    return [LintError(rel, node.lineno, "bare-assert",
                      "bare assert in non-test code (stripped under "
                      "python -O); raise ValueError/RuntimeError")
            for node in ast.walk(tree) if isinstance(node, ast.Assert)]


# --------------------------------------------------------------------------- #
# rule: parity-tags
# --------------------------------------------------------------------------- #
_PARITY_RE = re.compile(r"PARITY:\s*(\w+)")
_PARITY_CLASSES = ("BITWISE", "ALLCLOSE")
#: modules whose functions of these names must carry a tag
_PARITY_REQUIRED = {
    "src/repro_torch/core/wire.py": re.compile(
        r"^(_ring_(all_gather|reduce_scatter|acc_reduce_scatter)"
        r"|_q8_(route|ring_acc)_reduce_scatter|_fp8_route_reduce_scatter"
        r"|dtype_reduce_scatter|codec_reduce_scatter"
        r"|payload_all_gather|(codec|q8|fp8)_gather)$"),
    "src/repro_torch/kernels/ops.py": re.compile(r"^[a-z]\w*$"),
}


def check_parity_tags(rel: str, tree: ast.AST, src: str) -> list[LintError]:
    """Wire and kernel primitives declare their PARITY class."""
    required = _PARITY_REQUIRED.get(rel)
    errs = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        m = _PARITY_RE.search(ast.get_docstring(node) or "")
        if m is None:
            if required is not None and required.match(node.name):
                errs.append(LintError(
                    rel, node.lineno, "parity-tags",
                    f"comm/codec primitive {node.name!r} has no "
                    f"'PARITY: BITWISE|ALLCLOSE' docstring tag"))
            continue
        if m.group(1) not in _PARITY_CLASSES:
            errs.append(LintError(
                rel, node.lineno, "parity-tags",
                f"{node.name!r} declares unknown parity class "
                f"{m.group(1)!r} (one of {_PARITY_CLASSES})"))
    return errs


# --------------------------------------------------------------------------- #
# rule: tracked-bytecode (repo-level)
# --------------------------------------------------------------------------- #
def check_tracked_bytecode(root: Path) -> list[LintError]:
    """No git-tracked *.pyc / __pycache__ entries."""
    try:
        out = subprocess.run(["git", "ls-files"], cwd=root, check=True,
                             capture_output=True, text=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return []  # not a git checkout: nothing to check
    return [LintError(f, 0, "tracked-bytecode",
                      "compiled bytecode tracked by git; `git rm --cached` "
                      "it (covered by .gitignore)")
            for f in out.splitlines()
            if f.endswith((".pyc", ".pyo")) or "__pycache__" in f]


# --------------------------------------------------------------------------- #
# driver
# --------------------------------------------------------------------------- #
#: file-level rules: name -> factory(root) -> check(rel, tree, src)
RULES: dict[str, Callable[[Path], Callable]] = {
    "no-reference-import": lambda root: check_no_reference_import,
    "quant-blockwise": lambda root: check_quant_blockwise,
    "bare-assert": lambda root: check_bare_assert,
    "parity-tags": lambda root: check_parity_tags,
}
#: repo-level rules: name -> check(root)
REPO_RULES: dict[str, Callable[[Path], list]] = {
    "tracked-bytecode": check_tracked_bytecode,
}

#: default scan: the port and its chip script
DEFAULT_SCAN = ("src/repro_torch", "chip_smoke.py")


def run_lint(root, paths: Optional[Iterable] = None,
             select: Optional[Iterable[str]] = None) -> list[LintError]:
    """Run the selected rules (default: all) over ``paths`` (default:
    ``DEFAULT_SCAN`` under ``root``); returns every finding, sorted by
    location."""
    root = Path(root).resolve()
    names = list(select) if select else [*RULES, *REPO_RULES]
    unknown = set(names) - set(RULES) - set(REPO_RULES)
    if unknown:
        raise ValueError(f"unknown lint rules: {sorted(unknown)}; "
                         f"available: {sorted([*RULES, *REPO_RULES])}")
    checks = [RULES[n](root) for n in names if n in RULES]

    files = []
    for p in (DEFAULT_SCAN if paths is None else paths):
        p = Path(p)
        p = p if p.is_absolute() else root / p
        if p.is_dir():
            files += sorted(p.rglob("*.py"))
        elif p.exists():
            files.append(p)

    errs: list[LintError] = []
    for py in files:
        rel = py.resolve().relative_to(root).as_posix()
        src = py.read_text()
        try:
            tree = ast.parse(src, filename=str(py))
        except SyntaxError as e:
            errs.append(LintError(rel, e.lineno or 0, "syntax",
                                  f"unparseable: {e.msg}"))
            continue
        for check in checks:
            errs.extend(check(rel, tree, src))
    for n in names:
        if n in REPO_RULES:
            errs.extend(REPO_RULES[n](root))
    return sorted(errs, key=lambda e: (e.path, e.line, e.rule))


def main(argv: Optional[list[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="the port's layering lint (repro_torch.analysis.lint)")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: src/repro_torch "
                         "chip_smoke.py)")
    ap.add_argument("--root", default=None,
                    help="repo root (default: three levels above this "
                         "package)")
    ap.add_argument("--select", action="append", default=None,
                    metavar="RULE", help="run only these rules")
    args = ap.parse_args(argv)
    # lint.py sits at <root>/src/repro_torch/analysis/lint.py
    root = Path(args.root) if args.root else \
        Path(__file__).resolve().parents[3]
    errs = run_lint(root, paths=args.paths or None, select=args.select)
    for e in errs:
        print(e)
    rules = ", ".join(args.select or [*RULES, *REPO_RULES])
    if errs:
        print(f"lint: {len(errs)} finding(s) [{rules}]")
        return 1
    print(f"lint ok [{rules}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
