"""Minimal, dependency-free lint gate.

The reference enforces formatting in CI (JuliaFormatter.yml + .dev/
climaformat.jl); this environment ships no ruff/flake8/black, so the gate
is a small AST/text checker covering the defect classes that matter for
this codebase, run by the CI lint job (.github/workflows/ci.yml):

- syntax errors (ast.parse of every file),
- unused imports (module scope; ``import x as _x`` and __init__ re-exports
  via __all__ or bare re-export modules are exempt),
- duplicate top-level def/class names (silent shadowing),
- trailing whitespace, tabs in indentation, missing final newline,
- lines over 99 columns (warning only unless --strict).

Exit code 0 = clean. Usage: python tools/lint.py [--strict] [paths...]
"""

import argparse
import ast
import os
import sys

DEFAULT_PATHS = (
    "cloudy_tpu", "tools", "tests", "examples", "bench.py",
    "__graft_entry__.py",
)
MAX_LINE = 99


def iter_py(paths):
    for p in paths:
        if os.path.isfile(p) and p.endswith(".py"):
            yield p
        elif os.path.isdir(p):
            for root, _dirs, files in os.walk(p):
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)


def check_file(path, strict):
    errors, warnings = [], []
    with open(path, encoding="utf-8") as f:
        src = f.read()
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [f"{path}:{e.lineno}: syntax error: {e.msg}"], []

    lines = src.split("\n")
    noqa = {i for i, l in enumerate(lines, 1) if "# noqa" in l}
    for i, line in enumerate(lines, 1):
        if line != line.rstrip():
            errors.append(f"{path}:{i}: trailing whitespace")
        stripped = line.lstrip()
        indent = line[: len(line) - len(stripped)]
        if "\t" in indent:
            errors.append(f"{path}:{i}: tab in indentation")
        if len(line) > MAX_LINE:
            warnings.append(f"{path}:{i}: line > {MAX_LINE} cols")
    if src and not src.endswith("\n"):
        errors.append(f"{path}: missing final newline")

    # duplicate top-level definitions (later silently shadows earlier)
    seen = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if node.name in seen:
                errors.append(
                    f"{path}:{node.lineno}: duplicate top-level definition "
                    f"'{node.name}' (first at line {seen[node.name]})"
                )
            else:
                seen[node.name] = node.lineno

    # unused module-scope imports
    is_reexport = os.path.basename(path) == "__init__.py"
    exported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "__all__":
                    if isinstance(node.value, (ast.List, ast.Tuple)):
                        exported = {
                            e.value
                            for e in node.value.elts
                            if isinstance(e, ast.Constant)
                        }
    imported = {}  # name -> lineno
    for node in tree.body:
        if isinstance(node, ast.Import):
            for a in node.names:
                name = (a.asname or a.name).split(".")[0]
                imported[name] = node.lineno
        elif isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                continue
            for a in node.names:
                if a.name == "*":
                    continue
                imported[a.asname or a.name] = node.lineno
    used = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Attribute):
            n = node
            while isinstance(n, ast.Attribute):
                n = n.value
            if isinstance(n, ast.Name):
                used.add(n.id)
    for name, lineno in sorted(imported.items()):
        if name.startswith("_") or name in exported or is_reexport:
            continue
        if lineno in noqa:
            continue
        if name not in used:
            errors.append(f"{path}:{lineno}: unused import '{name}'")

    return errors, warnings


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("paths", nargs="*", default=None)
    ap.add_argument("--strict", action="store_true",
                    help="long-line warnings become errors")
    args = ap.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    os.chdir(root)
    paths = args.paths or list(DEFAULT_PATHS)

    all_err, all_warn = [], []
    n = 0
    for path in iter_py(paths):
        n += 1
        e, w = check_file(path, args.strict)
        all_err += e
        all_warn += w
    if args.strict:
        all_err += all_warn
        all_warn = []
    for msg in all_warn:
        print(f"warning: {msg}")
    for msg in all_err:
        print(msg)
    print(f"lint: {n} files, {len(all_err)} errors, {len(all_warn)} warnings")
    sys.exit(1 if all_err else 0)


if __name__ == "__main__":
    main()
