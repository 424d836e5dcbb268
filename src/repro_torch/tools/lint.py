"""The port's lint command (counterpart of ``tools/lint.py``): runs
``repro_torch.analysis.lint`` over ``src/repro_torch`` and
``chip_smoke.py``; ``--select RULE`` (repeatable) runs a subset --
``--select quant-blockwise`` stands where ``tools/check_quant_imports.py``
stands.  The rules and their docs are in ``analysis/lint.py``.

    python -m repro_torch.tools.lint [--select RULE] [PATHS...]
"""
import sys

from ..analysis.lint import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
