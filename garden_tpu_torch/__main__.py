"""`python -m garden_tpu_torch` — the asset-pipeline CLI (see cli.py)."""

import sys

from garden_tpu_torch.cli import main

sys.exit(main())
