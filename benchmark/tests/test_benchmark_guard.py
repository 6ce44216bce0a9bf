"""Nothing the benchmark runs imports JAX, flax or the JAX package, and the
reference imports nothing of the program.  Top-level names are compared
whole: the program's name begins with the JAX package's."""

import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "designcsg_tpu"}


def imported_names(path: Path):
    """(top-level names of absolute imports, relative imports as (level,
    module)) anywhere in the file, functions included."""
    names, relative = set(), []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                relative.append((node.level, node.module or ""))
            else:
                names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(node.args[0].value.split(".")[0])
    return names, relative


def harness_files():
    return [p for p in (ROOT / "benchmark").rglob("*.py") if "tests" not in p.parts]


def test_harness_and_program_import_no_jax():
    files = harness_files() + sorted((ROOT / "designcsg_tpu_torch").rglob("*.py"))
    for path in files:
        names, _ = imported_names(path)
        assert not names & FORBIDDEN, (path, names & FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "benchmark" / "reference").rglob("*.py"):
        names, relative = imported_names(path)
        assert "designcsg_tpu_torch" not in names and not names & FORBIDDEN, path
        assert all(level == 1 for level, _ in relative), path  # within reference/


def _loaded(code: str):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_loaded_modules_of_a_run_and_of_the_reference():
    drivers = "\n".join(f"import benchmark.drivers.{p.stem}"
                        for p in (ROOT / "benchmark" / "drivers").glob("*.py"))
    run = _loaded("import benchmark.run, benchmark.trace\n" + drivers + "\n"
                  "import designcsg_tpu_torch.viewer, designcsg_tpu_torch.export.pipeline\n"
                  "import designcsg_tpu_torch.evaluator, designcsg_tpu_torch.designs.design1\n"
                  "import designcsg_tpu_torch.designs.design2, designcsg_tpu_torch.ops.cuda.march_kernel")
    assert "designcsg_tpu_torch" in run and not run & FORBIDDEN
    refs = "\n".join(f"import benchmark.reference.{p.stem}"
                     for p in (ROOT / "benchmark" / "reference").glob("*.py"))
    ref = _loaded(refs)
    assert not ref & (FORBIDDEN | {"designcsg_tpu_torch"})
