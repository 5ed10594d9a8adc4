"""Nothing the benchmark runs imports JAX or the JAX package, by whole
top-level name (``sift3d_torch`` is the port and allowed); the reference
imports nothing of the port either."""

import ast
import pathlib

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "sift3d"}


def _imports(path: pathlib.Path):
    """(module, level) of every import in a file."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, 0
        elif isinstance(node, ast.ImportFrom):
            yield node.module or "", node.level


def _file_of(module: str):
    """The benchmark's or the port's source file of a module, if it is one."""
    parts = module.split(".")
    bases = [BENCH] if parts[0] != "sift3d_torch" else [ROOT]
    for base in bases:
        p = base.joinpath(*parts)
        for cand in (p.with_suffix(".py"), p / "__init__.py"):
            if cand.is_file():
                return cand
    return None


def reached(entries):
    """Every top-level module name that the entry files reach through the
    benchmark's and the port's own modules, with the files walked."""
    seen, todo, roots = set(), list(entries), set()
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.add(f)
        for module, level in _imports(f):
            if level:  # relative: within the same package
                base = f.parent
                for _ in range(level - 1):
                    base = base.parent
                target = base.joinpath(*module.split(".")) if module else base
                for cand in (target.with_suffix(".py"), target / "__init__.py"):
                    if cand.is_file():
                        todo.append(cand)
                continue
            roots.add(module.split(".")[0])
            parts = module.split(".")
            for k in range(1, len(parts) + 1):
                g = _file_of(".".join(parts[:k]))
                if g is not None:
                    todo.append(g)
    return roots, seen


def _entries():
    return ([BENCH / "run.py", BENCH / "control.py"] + sorted((BENCH / "mixes").glob("*.py"))
            + sorted((BENCH / "metrics").glob("*.py")))


def test_nothing_the_benchmark_runs_imports_jax():
    roots, files = reached(_entries())
    assert not roots & FORBIDDEN, sorted(roots & FORBIDDEN)
    assert any("sift3d_torch" in str(f) for f in files)  # the walk does reach the port


def test_every_benchmark_file_is_free_of_jax():
    for f in BENCH.rglob("*.py"):
        assert not {m.split(".")[0] for m, lvl in _imports(f) if not lvl} & FORBIDDEN, f


def test_the_reference_imports_nothing_of_the_port():
    roots, files = reached(sorted((BENCH / "reference").rglob("*.py")))
    assert "sift3d_torch" not in roots
    assert not roots & FORBIDDEN
    assert not any(str(f).startswith(str(ROOT / "sift3d_torch")) for f in files)
