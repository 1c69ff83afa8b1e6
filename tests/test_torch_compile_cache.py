"""Each test process keeps the JAX package's compile cache to itself.

The port's tests hold it against the JAX package, whose drivers turn on
JAX's persistent compile cache (``fscl_tpu/utils/precompile.py``), in
``~/.cache/fscl_tpu_xla`` unless ``JAX_COMPILATION_CACHE_DIR`` names
another directory. Test runs that share a HOME then load what earlier runs
wrote. Where the CPU's features differ from those XLA records with an
entry, XLA logs a line of about 1.8 KB for each entry it loads. The
two-process workers of ``tests/test_multihost.py`` write those lines to a
pipe that is read only after they exit, so past 64 KiB they block on it.

Importing this module, as pytest does in every test process when it
collects ``tests/``, points the cache at a new directory of that process's
own under TMPDIR, unless the caller named one. Processes the tests start
inherit it. It is removed when the process exits.

  * the JAX package's cache, in a process started by a test, goes to the
    directory this module chose;
  * that directory is removed when its process exits.
"""

import atexit
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile

if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
    _CACHE_DIR = tempfile.mkdtemp(prefix="fscl_tpu_xla-")
    os.environ["JAX_COMPILATION_CACHE_DIR"] = _CACHE_DIR
    atexit.register(shutil.rmtree, _CACHE_DIR, ignore_errors=True)

REPO = pathlib.Path(__file__).resolve().parents[1]


def _run(code, env):
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, check=True,
        capture_output=True, text=True, timeout=120,
    )
    return out.stdout.strip().splitlines()[-1]


def test_started_process_caches_in_the_chosen_directory():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    got = _run(
        "import jax\n"
        "from fscl_tpu.utils.precompile import enable_compile_cache\n"
        "enable_compile_cache()\n"
        "print(jax.config.jax_compilation_cache_dir)\n",
        env,
    )
    assert got == os.environ["JAX_COMPILATION_CACHE_DIR"]
    assert not got.startswith(os.path.expanduser("~/.cache"))


def test_directory_is_removed_when_its_process_exits(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["TMPDIR"] = str(tmp_path)
    got = _run(
        "import importlib.util, os\n"
        f"spec = importlib.util.spec_from_file_location('m', {__file__!r})\n"
        "m = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(m)\n"
        "d = os.environ['JAX_COMPILATION_CACHE_DIR']\n"
        "assert os.path.isdir(d), d\n"
        "print(d)\n",
        env,
    )
    assert pathlib.Path(got).parent == tmp_path
    assert not pathlib.Path(got).exists()
