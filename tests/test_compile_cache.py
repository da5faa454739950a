"""utils/compile_cache: one fixed cache location for every entry point.

Each case runs in a fresh interpreter, because JAX reads
JAX_COMPILATION_CACHE_DIR once, at import.
"""
import os
import subprocess
import sys

import pytest

from mcmctoffitting_tpu.utils import compile_cache

_PROBE = ("import jax; from mcmctoffitting_tpu.utils import compile_cache; "
          "print(compile_cache.enable()); "
          "print(jax.config.jax_compilation_cache_dir)")


def _probe(env_dir, cwd):
    env = {k: v for k, v in os.environ.items()
           if k != compile_cache.ENV_VAR}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = compile_cache.CHECKOUT + os.pathsep + env.get(
        "PYTHONPATH", "")
    if env_dir is not None:
        env[compile_cache.ENV_VAR] = env_dir
    r = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=cwd,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.split()


@pytest.mark.parametrize("case", ["env_set", "env_unset", "same_path"])
def test_cache_dir(case, tmp_path):
    if case == "env_set":
        # the variable wins and nothing in code sets another directory
        path = str(tmp_path / "cache")
        assert _probe(path, str(tmp_path)) == [path, path]
    elif case == "env_unset":
        want = os.path.join(compile_cache.CHECKOUT, ".jax_cache")
        assert _probe(None, str(tmp_path)) == [want, want]
    else:
        # a fixed path: the same from any working directory and process
        a = _probe(None, str(tmp_path))
        b = _probe(None, compile_cache.CHECKOUT)
        assert a == b
        assert str(os.getpid()) not in a[0]
        assert not a[0].startswith(os.path.expanduser("~") + os.sep) \
            or a[0].startswith(compile_cache.CHECKOUT)
