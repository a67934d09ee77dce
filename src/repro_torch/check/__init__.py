"""``python -m repro_torch.check`` — the static plan linter's CLI package.

The implementation lives in :mod:`repro_torch.analysis.cli`; this package
exists so the linter has a short, stable invocation name.
"""
from repro_torch.analysis.cli import main  # noqa: F401
