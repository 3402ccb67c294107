"""PyTorch port: its own ``Options`` / ``load_options`` against the JAX
package's, and the port's import isolation from the JAX package.

``subcort_tpu_torch.config`` keeps a copy of the reference's
``configuration.cfg`` contract so that the port imports nothing of the JAX
package; the two must read every file to the same options, apart from the
two defaults the port changes on purpose: ``reg_backend`` is ``"torch"``
(registration on the card) where the JAX package's is ``"native"`` (the C++
tools on the CPU), and ``cc_backend`` is ``"auto"`` (the component filter
on the card where the engine runs on one) where the JAX package's is
``"scipy"``.
"""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

from subcort_tpu.config import Options as JaxOptions
from subcort_tpu.config import load_options as jax_load_options
from subcort_tpu.config import print_options as jax_print_options
from subcort_tpu_torch.config import Options, load_options, print_options

REPO = Path(__file__).resolve().parent.parent
EXAMPLE = REPO / "examples" / "configuration.cfg"

CUSTOM = """\
[database]
inference_folder = /data/test
t1_name = scan.nii.gz

[model]
name =  custom
mode = cuda1
patch_size = 32
test_batch_size = 4096
debug = False
speedup_segmentation = False

[tpu]
use_fcn = False
compute_dtype = bfloat16
dilate_crop_iters = 3
"""


def _as_port(jax_options) -> dict:
    """The JAX package's options as the port must read them: equal, apart
    from the ``reg_backend`` and ``cc_backend`` defaults."""
    want = dataclasses.asdict(jax_options)
    assert want["reg_backend"] == "native" and want["cc_backend"] == "scipy"
    return dict(want, reg_backend="torch", cc_backend="auto")


@pytest.mark.parametrize("source", ["example", "custom", "empty"])
def test_load_options_matches_jax_package(tmp_path, source):
    if source == "example":
        path = EXAMPLE
    else:
        path = tmp_path / "configuration.cfg"
        path.write_text(CUSTOM if source == "custom" else "[model]\n")
    got, want = load_options(path), jax_load_options(path)
    assert isinstance(got, Options)
    if source == "example":  # names both backends itself: read alike
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    else:
        assert dataclasses.asdict(got) == _as_port(want)
    if source == "custom":
        assert (got.mode, got.use_fcn, got.compute_dtype,
                got.test_batch_size) == ("cuda1", False, "bfloat16", 4096)


def test_options_defaults_keys_and_dump_match_jax_package(capsys):
    got, want = Options(), JaxOptions()
    assert dataclasses.asdict(got) == _as_port(want)
    assert list(got) == list(want) and got.mode == "tpu"
    got["debug"] = "False"
    assert got.bool("debug") is False and got["debug"] == "False"
    with pytest.raises(KeyError):
        got["no_such_key"]
    print_options(Options(mode="cpu"))
    mine = capsys.readouterr().out
    jax_print_options(JaxOptions(mode="cpu", reg_backend="torch",
                                 cc_backend="auto"))
    assert mine == capsys.readouterr().out


def _is_jax_package(name: str) -> bool:
    return name in ("jax", "subcort_tpu") or name.startswith(
        ("jax.", "subcort_tpu."))


def test_port_imports_nothing_of_jax_or_the_jax_package():
    """Every module of the port, imported in a fresh interpreter, leaves
    no ``jax`` or ``subcort_tpu`` module behind."""
    code = (
        "import importlib, pkgutil, sys, subcort_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "subcort_tpu_torch.__path__, 'subcort_tpu_torch.')]\n"
        "for name in names: importlib.import_module(name)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k in ('jax', 'subcort_tpu')"
        " or k.startswith(('jax.', 'subcort_tpu.')))\n"
        "print(len(names), bad)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    count, bad = proc.stdout.split(" ", 1)
    assert int(count) >= 17
    assert bad.strip() == "[]"


def _imported_names(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_and_chip_smoke_name_no_jax_import():
    """No import statement, at any depth, in the port's sources or in
    chip_smoke.py names jax or the JAX package."""
    files = sorted((REPO / "subcort_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) >= 18
    for path in files:
        bad = [n for n in _imported_names(path) if _is_jax_package(n)]
        assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_parallel_modules_import_no_engine():
    """The mechanism layer stays below the engine: no import statement,
    at any depth, in a module under ``subcort_tpu_torch/parallel/`` names
    ``subcort_tpu_torch.engine`` or anything in it."""
    files = sorted((REPO / "subcort_tpu_torch" / "parallel").glob("*.py"))
    assert len(files) >= 4
    for path in files:
        names = []
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names += [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom):
                assert node.level == 0, f"{path.name}: a relative import"
                names += [node.module] + [f"{node.module}.{alias.name}"
                                          for alias in node.names]
        bad = [n for n in names if n == "subcort_tpu_torch.engine"
               or n.startswith("subcort_tpu_torch.engine.")]
        assert not bad, f"{path.relative_to(REPO)} imports {bad}"


# the JAX package's exports with no counterpart in the port: its
# functional forward (the port's is TriPlanarNet) and its compilation cache
NOT_EXPORTED = {"apply", "apply_branch", "enable_compilation_cache", "timer"}


def _exported(path: Path) -> set:
    return {alias.asname or alias.name
            for node in ast.parse(path.read_text()).body
            if isinstance(node, ast.ImportFrom)
            for alias in node.names}


@pytest.mark.parametrize("package", ["", "engine", "ops", "models", "utils"])
def test_port_exports_what_the_jax_package_exports(package):
    """Every name a JAX package ``__init__`` imports for its users, the
    port's counterpart exports too (less ``NOT_EXPORTED``), and it resolves."""
    import importlib

    want = _exported(REPO / "subcort_tpu" / package / "__init__.py")
    module = importlib.import_module(
        "subcort_tpu_torch" + (f".{package}" if package else ""))
    missing = sorted(n for n in want - NOT_EXPORTED
                     if not hasattr(module, n))
    assert not missing, f"subcort_tpu_torch.{package} lacks {missing}"


@pytest.mark.parametrize("module", ["subcort_tpu_torch.cli",
                                    "subcort_tpu_torch.engine.loo",
                                    "subcort_tpu_torch.ops.connected",
                                    "subcort_tpu_torch.utils.runtime",
                                    "subcort_tpu_torch.parallel.distributed",
                                    "subcort_tpu_torch.parallel.sync_bn",
                                    "subcort_tpu_torch.engine.train",
                                    "subcort_tpu_torch.utils.graphs",
                                    "subcort_tpu_torch.engine.views",
                                    "subcort_tpu_torch.models.fastsurfer",
                                    "subcort_tpu_torch.ops.scan_inputs",
                                    "subcort_tpu_torch.ops.bn_prelu"])
def test_new_modules_alone_import_no_jax(module):
    """Each module of the command-line and multi-device slices, and the
    CUDA-graph helper of the registration levels and the train multistep,
    alone in a fresh interpreter (the CLI's parser built as well), loads
    no ``jax`` or ``subcort_tpu`` module; ``parallel.distributed``
    launches every rank the trainer spawns, and ``engine.train`` holds
    the rank's entry."""
    code = (f"import sys, importlib\n"
            f"m = importlib.import_module({module!r})\n"
            "getattr(m, '_build_parser', lambda: None)()\n"
            "print(sorted(k for k in sys.modules if k in ('jax', "
            "'subcort_tpu') or k.startswith(('jax.', 'subcort_tpu.'))))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
