"""``python -m repro_torch.obs.diff A B [--html REPORT.html]`` — compare two
``--report-out`` run bundles. Thin entry point over
:func:`repro_torch.obs.audit.diff.main`; exits nonzero when hard diffs exist."""
from __future__ import annotations

import sys

from repro_torch.obs.audit.diff import main

if __name__ == "__main__":
    sys.exit(main())
