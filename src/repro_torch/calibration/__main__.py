"""``python -m repro_torch.calibration`` — the calibration CLI.

A separate ``__main__`` (rather than ``python -m repro_torch.calibration.run``)
so runpy does not re-execute a module the package ``__init__`` already
imported.
"""

import sys

from .run import main

if __name__ == "__main__":
    sys.exit(main())
