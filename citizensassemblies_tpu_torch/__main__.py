"""``python -m citizensassemblies_tpu_torch`` — the analysis CLI (reference
``analysis.py:646-705``)."""

from citizensassemblies_tpu_torch.analysis.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
