"""Nothing under benchmark/ imports JAX or the JAX package, compared by the
whole top-level name (``f5_tts_tpu_torch`` passes, ``f5_tts_tpu`` does not)."""

import ast
import os
import sys

from benchmark import run

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def imported_tops(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".", 1)[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".", 1)[0]


def test_no_file_imports_jax_or_the_jax_package():
    found = []
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                p = os.path.join(d, f)
                found += [(p, t) for t in imported_tops(p) if t in run.BANNED]
    assert not found, found


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "f5_tts_tpu_torch_lookalike", sys)
    assert "f5_tts_tpu_torch_lookalike" not in run.banned_modules()
    monkeypatch.setitem(sys.modules, "f5_tts_tpu.models", sys)
    assert "f5_tts_tpu.models" in run.banned_modules()


def test_the_scan_sees_an_import_of_the_jax_package(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import f5_tts_tpu_torch.models\nfrom f5_tts_tpu.ops import mel\n")
    assert [t for t in imported_tops(str(p)) if t in run.BANNED] == ["f5_tts_tpu"]
