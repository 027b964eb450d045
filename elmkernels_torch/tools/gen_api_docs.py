"""Write ``docs/API_torch.md`` from the docstrings of ``elmkernels_torch``.

    python -m elmkernels_torch.tools.gen_api_docs [out.md]

The port's twin of the JAX package's ``tools/gen_api_docs.py`` (which
writes ``docs/API.md`` for the JAX package).  It walks the port's modules
WITHOUT importing them (by ``ast``, so nothing is built or loaded) and
writes a section per module: the first paragraph of its docstring and each
public function and class with its signature and the first paragraph of
its docstring.
"""

from __future__ import annotations

import ast
import pathlib
import sys

PKG = pathlib.Path(__file__).resolve().parents[1]
DEFAULT_OUT = PKG.parent / "docs" / "API_torch.md"


def first_para(doc: str | None) -> str:
    if not doc:
        return ""
    return doc.strip().split("\n\n")[0].replace("\n", " ")


def fmt_args(fn: ast.FunctionDef) -> str:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args]
    ndef = len(a.defaults)
    if ndef:
        names[-ndef:] = [f"{n}=…" for n in names[-ndef:]]
    if a.vararg:
        names.append("*" + a.vararg.arg)
    for kw, d in zip(a.kwonlyargs, a.kw_defaults):
        names.append(f"{kw.arg}=…" if d is not None else kw.arg)
    sig = ", ".join(names)
    return sig if len(sig) <= 70 else sig[:67] + "…"


def module_section(path: pathlib.Path) -> str | None:
    rel = path.relative_to(PKG.parent)
    tree = ast.parse(path.read_text())
    out = [f"## `{rel}`\n"]
    mdoc = ast.get_docstring(tree)
    if mdoc:
        out.append(first_para(mdoc) + "\n")
    rows = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if node.name.startswith("_"):
                continue
            rows.append(f"- **`{node.name}({fmt_args(node)})`** — "
                        f"{first_para(ast.get_docstring(node))}")
        elif isinstance(node, ast.ClassDef):
            if node.name.startswith("_"):
                continue
            rows.append(f"- **`class {node.name}`** — "
                        f"{first_para(ast.get_docstring(node))}")
            for sub in node.body:
                if (isinstance(sub, ast.FunctionDef)
                        and not sub.name.startswith("_")):
                    rows.append(
                        f"  - `.{sub.name}({fmt_args(sub)})` — "
                        f"{first_para(ast.get_docstring(sub))}")
    if not rows and not mdoc:
        return None
    out.extend(rows)
    return "\n".join(out) + "\n"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    out_path = pathlib.Path(argv[0]) if argv else DEFAULT_OUT
    sections = []
    for path in sorted(PKG.rglob("*.py")):
        if path.name == "__init__.py" and not ast.get_docstring(
                ast.parse(path.read_text())):
            continue
        sec = module_section(path)
        if sec:
            sections.append(sec)
    header = (
        "# elmkernels_torch API reference\n\n"
        "Generated by `python -m elmkernels_torch.tools.gen_api_docs` — do "
        "not edit by hand.\nEach entry's full docstring cites its JAX "
        "counterpart and the reference's sources; see the module source "
        "for details.\n\n")
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(header + "\n".join(sections))
    print(f"wrote {out_path} ({len(sections)} modules)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
