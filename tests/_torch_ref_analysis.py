"""The reference's plan verifier and lint (``repro.analysis.verify``,
``repro.analysis.lint``), loaded without ``repro/analysis/__init__.py``.

On JAX 0.9.0 ``import repro.analysis`` fails: its ``__init__`` imports
``jaxpr.py``, whose line 28 reads ``jax.core.ClosedJaxpr``, which that
JAX removed (so ``tests/test_analysis.py`` errors at collection).
``verify.py`` and ``lint.py`` need neither at import: ``lint.py`` imports
only the standard library, and ``verify.py`` imports ``..core.profile``,
``..core.store`` and ``.jaxpr`` inside its functions.  ``reference_analysis``
puts a stub parent package ``repro.analysis`` (its ``__path__`` the real
directory, so the two modules load from their own files, unchanged) and a
stub ``repro.analysis.jaxpr`` into ``sys.modules`` for the body of the
``with``, and restores ``sys.modules`` after.  Nothing under
``src/repro/`` changes.  The stub's two names are the ones the
reference's ``_check_no_f32_dequant`` imports before it returns on a
trace with no jaxpr; calling either raises.
"""
import contextlib
import importlib
import pathlib
import sys
import types

_NAMES = ("repro.analysis", "repro.analysis.jaxpr", "repro.analysis.verify",
          "repro.analysis.lint")


def _no_jaxpr(*args, **kwargs):
    raise RuntimeError("the stub repro.analysis.jaxpr has no jaxpr walker")


@contextlib.contextmanager
def reference_analysis():
    """``(verify, lint)``, the reference's modules, inside the ``with``."""
    import repro

    saved = {n: sys.modules.get(n) for n in _NAMES}
    pkg = types.ModuleType("repro.analysis")
    # ``repro`` is a namespace package: its directory is its ``__path__``
    pkg.__path__ = [str(pathlib.Path(list(repro.__path__)[0]) /
                        "analysis")]
    jaxpr = types.ModuleType("repro.analysis.jaxpr")
    jaxpr._as_jaxpr = jaxpr._sub_jaxprs = _no_jaxpr
    sys.modules["repro.analysis"] = pkg
    sys.modules["repro.analysis.jaxpr"] = jaxpr
    for n in _NAMES[2:]:
        sys.modules.pop(n, None)
    try:
        yield (importlib.import_module("repro.analysis.verify"),
               importlib.import_module("repro.analysis.lint"))
    finally:
        for n, mod in saved.items():
            if mod is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = mod
