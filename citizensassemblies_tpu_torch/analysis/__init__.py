"""Analysis & reporting layer (reference ``analysis.py`` L3-L5).

* :mod:`.cache` — pickle memoization of algorithm runs (``analysis.py:271-327``).
* :mod:`.plots` — the five-figure plotting suite (``analysis.py:330-456,519-528``).
* :mod:`.report` — the ``analyze_instance`` orchestrator, statistics.txt writer
  and timing harness (``analysis.py:533-636``).
* :mod:`.cli` — the data-scanning argparse front end (``analysis.py:646-705``).
"""

from citizensassemblies_tpu_torch.analysis.cache import (  # noqa: F401
    AlgorithmRun,
    run_legacy_or_retrieve,
    run_leximin_or_retrieve,
    run_xmin_or_retrieve,
)
from citizensassemblies_tpu_torch.analysis.report import analyze_instance  # noqa: F401
from citizensassemblies_tpu_torch.analysis.cli import main  # noqa: F401
